"""The training pair (kernels/fused_mlp_vjp.py) against the JAX package's
ray-major backward and against PyTorch autograd.

On the CPU the backward wrapper runs its plain version.  The JAX side runs
``_bwd_rays_call`` in Pallas interpret mode, which computes in float32
(fused_mlp_vjp.py:314), as the JAX package's own tests do; the port's plain
version gets float32 packed weights, so both sides make the same products
in another order.  Gradients are compared per layer after mapping both
sides to the state-dict layout: the JAX side through the VJP of its
packing, the port through autograd of ``pack_flat``.

Tolerance, relative L2 per layer: 1e-5 between the port's own float32
paths (same forward, products in another order), 5e-5 against the JAX
package (measured 2.1e-5; its forward sums in yet another order).  Against
JAX, points with a ReLU input within 1e-5 of zero get zero cotangents on
both sides: there the gradient jumps, and two float32 forwards can put the
point on opposite sides (one such point moves a layer's gradient by up to
1% at this size; 7% of the points are dropped).

The kernel itself needs the card: tests/test_torch_cuda.py holds it
against this plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_pytorch_paeng_tpu.kernels import fused_mlp as jfm
from nerf_pytorch_paeng_tpu.kernels import fused_mlp_vjp as jfv
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp as fm
from nerf_pytorch_paeng_tpu_torch.kernels import fused_mlp_vjp as fv
from nerf_pytorch_paeng_tpu_torch.models.nerf import NeRF
from nerf_pytorch_paeng_tpu_torch.ops.posenc import build_emb
from nerf_pytorch_paeng_tpu_torch.utils.interop import \
    state_dict_from_jax_params

from torch_port_util import np_nerf_params, np_rays, to_jax

N, S = 128, 8
REL = 1e-5
REL_JAX = 5e-5
RELU_MARGIN = 1e-5


def _setup(seed, n=N, s=S):
    params = np_nerf_params(seed)
    model = NeRF()
    model.load_state_dict(state_dict_from_jax_params(params))
    rng = np.random.default_rng(seed + 100)
    od, z = np_rays(rng, n, s)
    cots = [(rng.normal(0, 1e-3, (s, n))).astype(np.float32)
            for _ in range(4)]
    return params, model.model_fine, od, z, cots


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _module_grads(mlp, dw, db):
    """Packed-layout gradients -> {state-dict key: gradient} through the
    VJP of the differentiable packing."""
    w, b = fm.pack_flat(mlp)
    params = dict(mlp.named_parameters())
    grads = torch.autograd.grad([w, b], list(params.values()),
                                grad_outputs=[dw, db])
    return {f"model_fine.{k}": g for k, g in zip(params, grads)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_grads_close(got, want, rel=REL):
    assert set(got) == set(want)
    for key in want:
        g = got[key].detach().numpy() if torch.is_tensor(got[key]) \
            else got[key]
        w = want[key].detach().numpy() if torch.is_tensor(want[key]) \
            else want[key]
        assert g.shape == w.shape, key
        assert _rel(g, w) <= rel, (key, _rel(g, w))


def _relu_margin(od, z, p):
    """[S, N]: the smallest |ReLU input| of each point's forward (trunk
    and view layer), float32 packed weights ``p``."""
    o, d = od[0:3].T, od[3:6].T
    dn = d * torch.rsqrt((d * d).sum(-1, keepdim=True))
    hv_dir = build_emb(dn, 4, fm.EMBD_ROWS) @ p["wvd"] + p["bv"]
    out = torch.empty(z.shape)
    for k in range(z.shape[0]):
        embx = build_emb(o + d * z[k][:, None], 10, fm.EMBX_ROWS)
        pre = embx @ p["w0"] + p["b0"]
        margin = pre.abs().min(-1).values
        for i in range(1, 8):
            h = torch.relu(pre)
            pre = h @ p[f"w{i}" if i != 5 else "w5h"] + p[f"b{i}"]
            if i == 5:
                pre = pre + embx @ p["w5e"]
            margin = torch.minimum(margin, pre.abs().min(-1).values)
        feat = torch.relu(pre) @ p["wfeat"] + p["bfeat"]
        pre = feat @ p["wvf"] + hv_dir
        out[k] = torch.minimum(margin, pre.abs().min(-1).values)
    return out


def test_bwd_plain_matches_jax_bwd_rays_call():
    """Plain K2 against ``_bwd_rays_call(interpret=True)`` per layer."""
    params, mlp, od, z, cots = _setup(0)
    packed = fm.pack_nerf_mlp_params(mlp, dtype=torch.float32)
    keep = (_relu_margin(*_t(od, z), packed) >= RELU_MARGIN).numpy()
    assert keep.mean() > 0.9
    cots = [np.where(keep, c, 0.0).astype(np.float32) for c in cots]
    jparams = to_jax(params["fine"])
    packed_j, unpack = jax.vjp(jfm.pack_nerf_mlp_params, jparams)
    call = jax.jit(lambda od, z, *g: jfv._bwd_rays_call(
        od, z, *g, packed_j, 10, 4, N, interpret=True))
    dpacked = call(jnp.asarray(od), jnp.asarray(z),
                   *(jnp.asarray(c) for c in cots))
    tree = unpack(dpacked)[0]
    want = {k: v.numpy() for k, v in state_dict_from_jax_params(
        {"coarse": tree, "fine": tree}).items() if k.startswith("model_fine")}

    dw, db = fv.fused_mlp_bwd_rays(*_t(od, z, *cots), packed)
    assert dw.dtype == db.dtype == torch.float32
    assert dw.shape == (fm.W_TOTAL,) and db.shape == (fm.B_TOTAL,)
    _assert_grads_close(_module_grads(mlp, dw, db), want, REL_JAX)


def _autograd_of_plain(mlp, od, z, cots, dtype=torch.float32):
    """Module gradients by autograd through the plain forward."""
    mlp.zero_grad(set_to_none=True)
    w, b = fm.pack_flat(mlp)
    outs = fm.fused_mlp_eval_rays_plain(od, z, fm._with_views(w.to(dtype), b))
    torch.autograd.backward(outs, cots)
    return {f"model_fine.{k}": p.grad.clone()
            for k, p in mlp.named_parameters()}


def test_bwd_plain_matches_autograd_of_plain_forward():
    """float32: the hand-written chain is the derivative of the forward."""
    _, mlp, od, z, cots = _setup(1)
    od, z, *cots = _t(od, z, *cots)
    want = _autograd_of_plain(mlp, od, z, cots)
    packed = fm.pack_nerf_mlp_params(mlp, dtype=torch.float32)
    dw, db = fv.fused_mlp_bwd_rays_plain(od, z, *cots, packed)
    _assert_grads_close(_module_grads(mlp, dw, db), want)


@pytest.mark.parametrize("ray_parts,sample_parts", [(2, 1), (1, 4), (4, 2)])
def test_bwd_grads_accumulate_across_chunks(ray_parts, sample_parts):
    """Splitting the points over rays and samples and adding the parts
    gives the whole batch's gradients (the kernel's blocks and chunks)."""
    _, mlp, od, z, cots = _setup(2, n=256, s=16)
    od, z, *cots = _t(od, z, *cots)
    packed = fm.pack_nerf_mlp_params(mlp, dtype=torch.float32)
    whole = fv.fused_mlp_bwd_rays(od, z, *cots, packed)
    parts = [torch.zeros_like(whole[0]), torch.zeros_like(whole[1])]
    for rays in torch.arange(256).chunk(ray_parts):
        for rows in torch.arange(16).chunk(sample_parts):
            sub = [c[rows][:, rays].contiguous() for c in [z, *cots]]
            dw, db = fv.fused_mlp_bwd_rays(od[:, rays].contiguous(), sub[0],
                                           *sub[1:], packed)
            parts[0] += dw
            parts[1] += db
    for got, want in zip(parts, whole):
        assert _rel(got.numpy(), want.numpy()) <= REL


def test_train_pair_grads_reach_the_module():
    """``fused_mlp_train_rays`` (K1 forward, K2 backward) under autograd:
    the module's parameters get the gradients of autograd through the
    plain forward.  Cotangents arrive non-contiguous (a transposed use of
    an output) and one output is unused."""
    _, mlp, od, z, _ = _setup(3)
    od, z = _t(od, z)
    tgt = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(N, S)).astype(np.float32))

    def loss_of(outs):
        r, g, _, sg = outs
        return (torch.mean((r.T - tgt) ** 2) + torch.mean(g ** 2)
                + torch.mean(torch.relu(sg)))

    mlp.zero_grad(set_to_none=True)
    w, b = fm.pack_flat(mlp)
    outs = fv.fused_mlp_train_rays(w, b, od, z, weight_dtype=torch.float32)
    assert all(o.dtype == torch.float32 and o.shape == (S, N) for o in outs)
    loss_of(outs).backward()
    got = {f"model_fine.{k}": p.grad.clone()
           for k, p in mlp.named_parameters()}

    mlp.zero_grad(set_to_none=True)
    w, b = fm.pack_flat(mlp)
    loss_of(fm.fused_mlp_eval_rays_plain(od, z, fm._with_views(w, b))).backward()
    want = {f"model_fine.{k}": p.grad.clone()
            for k, p in mlp.named_parameters()}
    _assert_grads_close(got, want)


def test_pack_flat_is_the_packed_layout():
    """The differentiable packing builds the no-grad packing's values."""
    _, mlp, _, _, _ = _setup(5)
    w, b = fm.pack_flat(mlp)
    assert w.requires_grad and b.requires_grad
    packed = fm.pack_nerf_mlp_params(mlp, dtype=torch.float32)
    assert torch.equal(w.detach(), packed["w"])
    assert torch.equal(b.detach(), packed["b"])


def test_cpu_dispatch_counts_no_launch():
    _, mlp, od, z, cots = _setup(6, n=8, s=2)
    packed = fm.pack_nerf_mlp_params(mlp, dtype=torch.float32)
    before = fv.fused_mlp_bwd_rays.launches
    fv.fused_mlp_bwd_rays(*_t(od, z, *cots), packed)
    assert fv.fused_mlp_bwd_rays.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "noncontig"])
def test_bwd_wrapper_rejects_bad_cotangents(bad):
    _, mlp, od, z, cots = _setup(7, n=16, s=4)
    od, z, *cots = _t(od, z, *cots)
    if bad == "shape":
        cots[1] = cots[1][:2].contiguous()
    elif bad == "dtype":
        cots[2] = cots[2].double()
    else:
        cots[3] = cots[3].T.contiguous().T
    packed = fm.pack_nerf_mlp_params(mlp, dtype=torch.float32)
    with pytest.raises(ValueError):
        fv.fused_mlp_bwd_rays(od, z, *cots, packed)


def test_bwd_flop_count():
    """At L_x=10, L_d=4: weight gradients 593,408 multiply-adds (wvd's
    27x128 included), input gradients of every layer but w0, w5e and wvd
    557,696."""
    assert fm.bwd_flop_per_sample(10, 4) == 2 * (593_408 + 557_696) \
        == 2_302_208
    assert fm.bwd_flop_per_sample(1, 1) == fm.bwd_flop_per_sample(10, 4) \
        - 2 * (2 * 54 * 256 + 18 * 128)
