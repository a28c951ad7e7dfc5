"""The port's encoder-decoder (seamless-m4t-medium, audio frontend stub)
and vision-stub (internvl2-76b) families, cross-attention, flash at
T > S, the shape cells and ``input_specs`` against the JAX package's, on
the CPU.

Reduced configs: 2 layers (seamless: 2 encoder + 2 decoder), d_model 128,
vocab 512, float32; weights from the reference's ``Model.init`` through
the bridge; token ids, source-frame and patch embeddings (std 0.1) drawn
with numpy from a seed.

As in the reference, seamless's decoder plans ``attn`` layers, so the
``xdec`` kind (self-attention + cross-attention to the encoder's output)
is held against the reference's layer on its own.

Tolerances, and why:
  * flash's plain version against the reference's Pallas kernel in
    interpret mode at non-causal T > S: ``atol=2e-5, rtol=1e-4`` (the
    reference's flash sweep tolerance, test_torch_lm.py's);
  * layers and the encoder's output: ``atol=1e-5, rtol=1e-5``; logits
    ``atol=1e-4, rtol=1e-4``; loss and gradients ``rtol=1e-5,
    atol=1e-6`` (test_torch_lm.py's and test_torch_train.py's);
  * shapes, dtypes and the shape cells: exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import shapes as j_shapes  # noqa: E402
from repro.kernels.flash.ops import flash_attention as j_flash  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.models.api import input_specs as j_input_specs  # noqa: E402
from repro.utils import pytree as j_pytree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS, shapes  # noqa: E402
from repro_torch.kernels.flash import flash as flash_kernel  # noqa: E402
from repro_torch.kernels.flash.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash.ref import attention_ref  # noqa: E402
from repro_torch.models import attention as PA  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.api import (  # noqa: E402
    EncDecModel,
    build_model,
    input_specs,
)
from repro_torch.models.layers import Init  # noqa: E402
from repro_torch.utils.pytree import load_leaves  # noqa: E402

CPU = "cpu"
ACT = dict(atol=1e-5, rtol=1e-5)
LOGITS = dict(atol=1e-4, rtol=1e-4)
GRAD = dict(rtol=1e-5, atol=1e-6)
SEAMLESS, VLM = "seamless-m4t-medium", "internvl2-76b"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree) -> dict:
    out = {}
    j_pytree.tree_map_with_path_str(
        lambda p, x: out.__setitem__(p, np.asarray(x)), tree)
    return out


def _assert_trees(got, want, label, **tol):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want), label
    for p, w in want.items():
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[p], w, err_msg=f"{label} {p}")
        else:
            np.testing.assert_allclose(got[p], w, err_msg=f"{label} {p}",
                                       **tol)


@pytest.fixture(scope="module", params=[SEAMLESS, VLM])
def pair(request):
    arch = request.param
    jm = j_build(J_ARCHS[arch].reduced().replace(attn_impl="chunked"))
    jp = jm.init(jax.random.key(0))
    pm = build_model(ARCHS[arch].reduced().replace(attn_impl="chunked"), CPU)
    return arch, jm, jp, pm, bridge.lm_params_from_numpy(pm, _np(jp))


def _batch(arch, b, t, seed):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, 512, size=(b, t)).astype(np.int32),
             "labels": rng.randint(0, 512, size=(b, t)).astype(np.int32)}
    if arch == SEAMLESS:
        batch["src_embeds"] = (rng.randn(b, 20, 128) * 0.1).astype(np.float32)
    else:
        batch["patch_embeds"] = (rng.randn(b, 8, 128) * 0.1).astype(
            np.float32)
    return batch


# --------------------------------------------------------- flash at T > S
# b, h, hkv, t, s, d: block multiples of the reference's kernel
FLASH_T_GT_S = [(1, 2, 1, 256, 128, 64), (1, 4, 2, 384, 64, 32),
                (2, 4, 4, 128, 32, 64), (1, 16, 16, 256, 16, 64)]


@pytest.mark.parametrize("b,h,hkv,t,s,d", FLASH_T_GT_S)
def test_flash_plain_matches_reference_kernel_at_t_above_s(b, h, hkv, t, s,
                                                           d):
    """Non-causal T > S (cross-attention with more decoder tokens than
    source frames): the plain version against the reference's Pallas
    kernel in interpret mode; the public wrapper takes the plain version
    for CPU tensors."""
    rng = np.random.RandomState(t + s)
    q, k, v = (rng.randn(*sh).astype(np.float32) * 0.3
               for sh in ((b, h, t, d), (b, hkv, s, d), (b, hkv, s, d)))
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=False))
    args = [torch.tensor(x) for x in (q, k, v)]
    n0 = flash_kernel.launches
    got = attention_ref(*args, causal=False)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    assert torch.equal(flash_attention(*args, causal=False), got)
    assert flash_kernel.launches == n0


@pytest.mark.parametrize("causal,window", [(True, None), (False, 4),
                                           (True, 4)])
def test_flash_refuses_masked_rows_that_see_no_key(causal, window):
    """T > S under a causal mask or a window leaves the first rows with no
    key: the wrapper refuses it on the CPU as the binding does on the
    card (no model reaches it)."""
    q = torch.zeros((1, 2, 8, 16))
    k = v = torch.zeros((1, 1, 4, 16))
    with pytest.raises(ValueError, match="T > S is taken without a mask"):
        flash_attention(q, k, v, causal=causal, window=window)


# ------------------------------------------------------- cross-attention
def _layer(kind, cfg, jlp):
    lp = PT.init_layer(Init(torch.device(CPU), None), cfg, kind)
    flat = _leaves(jlp)
    load_leaves(lp, flat, lambda p: torch.tensor(flat[p]))
    return lp


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
@pytest.mark.parametrize("t,s", [(32, 16), (16, 48), (1, 16)])
def test_xdec_and_enc_layers_match_reference(impl, t, s):
    """The ``xdec`` layer (causal self-attention, then cross-attention to
    ``enc_out`` [B, S, D], no rope, no mask) and the ``enc`` layer
    (bidirectional) against the reference's ``_apply_layer``, T above,
    below and at 1 against S."""
    jc = J_ARCHS[SEAMLESS].reduced().replace(attn_impl=impl)
    pc = ARCHS[SEAMLESS].reduced().replace(attn_impl=impl)
    rng = np.random.RandomState(t * s)
    x = (rng.randn(2, t, 128) * 0.5).astype(np.float32)
    enc = (rng.randn(2, s, 128) * 0.5).astype(np.float32)
    pos = np.arange(t, dtype=np.int32)
    for kind in ("xdec", "enc"):
        jlp = JT._init_layer(jax.random.key(3), jc, kind)
        jy, _, _ = JT._apply_layer(kind, jlp, jnp.asarray(x), jc,
                                   positions=jnp.asarray(pos),
                                   is_global=True, state=None, mode="train",
                                   enc_out=jnp.asarray(enc))
        py, aux = PT.apply_layer(kind, _layer(kind, pc, jlp),
                                 torch.tensor(x), pc,
                                 positions=torch.tensor(pos), is_global=True,
                                 state=None, mode="train",
                                 enc_out=torch.tensor(enc))
        assert aux is None
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), err_msg=kind,
                                   **ACT)


def test_cross_attention_matches_reference():
    """``attention(..., kv_input=)`` with ``positions=None``: K/V from the
    source, no rope; T = 40 against S = 24."""
    jc = J_ARCHS[SEAMLESS].reduced().replace(attn_impl="chunked")
    pc = ARCHS[SEAMLESS].reduced().replace(attn_impl="chunked")
    ja = JA.init_attention(jax.random.key(5), jc, cross=True)
    pa = PA.init_attention(Init(torch.device(CPU), None), pc, cross=True)
    flat = _leaves(ja)
    load_leaves(pa, flat, lambda p: torch.tensor(flat[p]))
    rng = np.random.RandomState(9)
    x = (rng.randn(2, 40, 128) * 0.5).astype(np.float32)
    src = (rng.randn(2, 24, 128) * 0.5).astype(np.float32)
    jo, _ = JA.attention(ja, jnp.asarray(x), jc, positions=None,
                         causal=False, kv_input=jnp.asarray(src))
    po = PA.attention(pa, torch.tensor(x), pc, positions=None, causal=False,
                      kv_input=torch.tensor(src))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **ACT)


# ------------------------------------------------------------ the models
def test_run_encoder_matches_reference(pair):
    arch, jm, jp, pm, pp = pair
    if arch != SEAMLESS:
        assert pp.enc_segments is None and not isinstance(pm, EncDecModel)
        return
    assert isinstance(pm, EncDecModel)
    src = _batch(arch, 2, 8, 1)["src_embeds"]
    want = jax.jit(lambda p, s: JT.run_encoder(p, s, jm.cfg))(
        jp, jnp.asarray(src))
    with torch.no_grad():
        got = PT.run_encoder(pp, torch.tensor(src), pm.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


def test_apply_train_loss_and_grads_match_reference(pair):
    arch, jm, jp, pm, pp = pair
    batch = _batch(arch, 2, 16, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.tensor(v) for k, v in batch.items()}
    jl, _ = jax.jit(jm.apply_train)(jp, jb)
    with torch.no_grad():
        pl, _ = pm.apply_train(pp, pb)
    assert pl.shape == (2, 16, 512)               # the prefix is cut off
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    params = bridge.lm_params_from_numpy(pm, _np(jp)).requires_grad_(True)
    named = dict(params.named_parameters())
    loss, _ = pm.loss(params, pb)
    # seamless's encoder reaches no logit (the reference's plan): its
    # gradients are zeros on both sides
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(named.values(), torch.autograd.grad(
                 loss, list(named.values()), allow_unused=True))]
    np.testing.assert_allclose(loss.item(), float(jloss), **GRAD)
    _assert_trees(bridge.lm_params_to_numpy(dict(zip(named, grads))),
                  _np(jg), "grads", **GRAD)


def test_prefill_and_decode_match_reference_and_train(pair):
    """Prefill of 11 tokens (with the source frames or the 8 patches) and
    two decode steps, against the reference's and the teacher-forced
    logits; the states (``enc_out`` too) after them, through the bridge."""
    arch, jm, jp, pm, pp = pair
    batch = _batch(arch, 2, 13, 3)
    toks = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    with torch.no_grad():
        pt, _ = pm.apply_train(pp, {k: torch.tensor(v)
                                    for k, v in batch.items()})
    bp = {"tokens": toks[:, :11], **extra}
    js = jm.init_states(2, 40)
    jl, js = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v)
                                      for k, v in bp.items()}, js)
    ps = pm.init_states(2, 40)
    pl, ps = pm.prefill(pp, {k: torch.tensor(v) for k, v in bp.items()}, ps)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
    np.testing.assert_allclose(pl.numpy(), pt.numpy()[:, 10], atol=2e-4)
    decode = jax.jit(jm.decode_step)
    for i in (11, 12):
        jl, js = decode(jp, jnp.asarray(toks[:, i:i + 1]), js)
        pl, ps = pm.decode_step(pp, torch.tensor(toks[:, i:i + 1]), ps)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGITS)
        np.testing.assert_allclose(pl.numpy(), pt.numpy()[:, i], atol=2e-4)
    got = bridge.lm_states_to_numpy(ps)
    _assert_trees(got, _np(js), "states", **ACT)
    back = bridge.lm_states_from_numpy(got, CPU)
    assert sorted(back) == sorted(ps)


# ------------------------------------------------ shape cells and specs
def test_shape_cells_match_reference():
    assert shapes.SHAPES.keys() == j_shapes.SHAPES.keys()
    for name, spec in shapes.SHAPES.items():
        want = j_shapes.SHAPES[name]
        assert (spec.name, spec.kind, spec.seq_len, spec.global_batch) == \
            (want.name, want.kind, want.seq_len, want.global_batch)
        red, jred = shapes.reduced_shape(spec), j_shapes.reduced_shape(want)
        assert (red.seq_len, red.global_batch) == (jred.seq_len,
                                                   jred.global_batch)
    cells = [(a, s) for a in ARCHS for s in shapes.SHAPES]
    assert len(cells) == 40
    for a, s in cells:
        assert shapes.applicable(ARCHS[a], shapes.SHAPES[s]) == \
            j_shapes.applicable(J_ARCHS[a], j_shapes.SHAPES[s])


_DT = {jnp.dtype(jnp.int32): torch.int32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("shape", list(j_shapes.SHAPES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_input_specs_match_reference(arch, shape):
    """Every input of the cell, on the meta device (no storage), with the
    reference's shape and dtype."""
    want = j_input_specs(J_ARCHS[arch], j_shapes.SHAPES[shape])
    got = input_specs(ARCHS[arch], shapes.SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == _DT[jnp.dtype(w.dtype)], k
