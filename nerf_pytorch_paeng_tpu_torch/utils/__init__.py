from .metrics import img2mse, mse2psnr, to8b  # noqa: F401
