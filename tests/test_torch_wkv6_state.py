"""The RWKV6 state written in place, against the JAX package, on the CPU.

``kernels/wkv6`` takes an output state ``s_out`` — ``s0`` itself for an
in-place update — and a ``commit`` mask ([B] bool): the committed rows'
final state goes to ``s_out``, the other rows are left exactly as they
were. The CUDA kernel keeps the same contract; here the plain versions
(``ops.wkv6`` on CPU tensors, ``wkv6_ref``, the model's ``wkv6_chunked``)
are held to the reference's ``wkv6_ref`` / ``wkv6_chunked_jnp``, which
return a new state, and the reduced rwkv6-3b's masked decode step to the
reference model's unmasked one.

Inputs are made with numpy from a seed. Tolerances: ``atol=1e-5,
rtol=1e-5`` — the same float32 recurrence summed in another order
(tests/test_torch_rwkv.py measures ≤ 7.2e-7); uncommitted rows are
compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.kernels.wkv6.ref import wkv6_ref as j_wkv6_ref  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.models.rwkv6 import wkv6_chunked_jnp  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6  # noqa: E402
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: E402
from repro_torch.models import rwkv6 as PR  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

CPU = "cpu"
ARCH = "rwkv6-3b"
TOL = dict(atol=1e-5, rtol=1e-5)
MASKS = {"partial": [True, False, True], "all": [True] * 3,
         "none": [False] * 3, "no mask": None}


def _inputs(b, h, t, d, seed):
    """The reference sweep's inputs (std 0.4, w = exp(-exp(N(0, 0.4))))
    and a random carried state."""
    rng = np.random.RandomState(seed)
    f = lambda *sh: rng.randn(*sh).astype(np.float32) * 0.4  # noqa: E731
    r, k, v = f(b, h, t, d), f(b, h, t, d), f(b, h, t, d)
    w = np.exp(-np.exp(f(b, h, t, d)))
    return r, k, v, w, f(h, d), f(b, h, d, d)


def _run(fn, args, s0, *, alias, mask, **kw):
    """``fn`` on torch copies of ``args`` with s0, an output state (s0
    itself, or a tensor of 7s) and the mask; returns (o, returned state,
    s_out after, s_out before, committed rows)."""
    pt = [torch.tensor(x) for x in args]
    s0_t = torch.tensor(s0)
    out = s0_t if alias else torch.full_like(s0_t, 7.0)
    before = out.clone()
    commit = None if mask is None else torch.tensor(mask)
    o, sf = fn(*pt, s0=s0_t, s_out=out, commit=commit, **kw)
    rows = np.ones(s0.shape[0], bool) if mask is None else np.asarray(mask)
    return o.numpy(), sf, out, before.numpy(), rows


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("alias", [True, False])
@pytest.mark.parametrize("t", [1, 37])
@pytest.mark.parametrize("fn", [wkv6, wkv6_ref], ids=["ops", "ref"])
def test_plain_state_in_place_matches_reference(fn, t, alias, mask):
    """``ops.wkv6`` on CPU tensors (the plain version, no launch) and
    ``wkv6_ref`` with s_out = s0 or another tensor: o and the committed
    rows' state equal the reference's ``wkv6_ref``; the other rows of
    s_out are untouched; the returned state is s_out."""
    *args, s0 = _inputs(3, 2, t, 32, seed=t + 1)
    jo, js = j_wkv6_ref(*(jnp.asarray(x) for x in args),
                        s0=jnp.asarray(s0))
    n0 = wkv6_kernel.launches
    o, sf, out, before, rows = _run(fn, args, s0, alias=alias,
                                    mask=MASKS[mask])
    assert wkv6_kernel.launches == n0
    assert sf is out
    np.testing.assert_allclose(o, np.asarray(jo), **TOL)
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(js)[rows],
                               **TOL)
    np.testing.assert_array_equal(out.numpy()[~rows], before[~rows])


@pytest.mark.parametrize("mask", ["partial", "no mask"])
@pytest.mark.parametrize("t,chunk", [(37, 64), (96, 32)])
def test_chunked_state_in_place_matches_reference(t, chunk, mask):
    """The model's "chunked" route writes its state the same way: against
    the reference's ``wkv6_chunked_jnp``."""
    *args, s0 = _inputs(3, 2, t, 32, seed=t)
    jo, js = wkv6_chunked_jnp(*(jnp.asarray(x) for x in args),
                              s0=jnp.asarray(s0), chunk=chunk)
    o, sf, out, before, rows = _run(PR.wkv6_chunked, args, s0, alias=True,
                                    mask=MASKS[mask], chunk=chunk)
    assert sf is out
    np.testing.assert_allclose(o, np.asarray(jo), **TOL)
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(js)[rows],
                               **TOL)
    np.testing.assert_array_equal(out.numpy()[~rows], before[~rows])


def test_state_written_through_a_view_of_the_stacked_state():
    """The engine hands each layer a view of the stacked [L, B, H, D, D]
    state: the write lands in the stack, the other layers untouched."""
    *args, s0 = _inputs(3, 2, 5, 32, seed=3)
    stack = torch.tensor(np.stack([s0, s0 + 1, s0 + 2]))
    keep = stack.clone()
    layer = stack[1]
    commit = torch.tensor([False, True, True])
    jo, js = j_wkv6_ref(*(jnp.asarray(x) for x in args),
                        s0=jnp.asarray(s0 + 1))
    o, sf = wkv6(*(torch.tensor(x) for x in args), s0=layer, s_out=layer,
                 commit=commit)
    np.testing.assert_allclose(stack[1, 1:].numpy(), np.asarray(js)[1:],
                               **TOL)
    assert torch.equal(stack[1, 0], keep[1, 0])
    assert torch.equal(stack[0], keep[0]) and torch.equal(stack[2], keep[2])


@pytest.mark.parametrize("fn", [wkv6, wkv6_ref, PR.wkv6_chunked],
                         ids=["ops", "ref", "chunked"])
def test_state_contract_refusals(fn):
    """A mask names rows of an output: without s_out it is refused; the
    output state is float32 and of the state's shape."""
    *args, s0 = _inputs(3, 2, 4, 32, seed=5)
    pt = [torch.tensor(x) for x in args]
    s0_t = torch.tensor(s0)
    with pytest.raises(ValueError, match="commit needs s_out"):
        fn(*pt, s0=s0_t, commit=torch.ones(3, dtype=torch.bool))
    with pytest.raises(TypeError, match="float32"):
        fn(*pt, s0=s0_t, s_out=s0_t.double())
    with pytest.raises(ValueError, match="shape"):
        fn(*pt, s0=s0_t, s_out=s0_t[:, :1])


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def rwkv():
    """(reference model, its params, the same params in the port)."""
    jm = j_build(J_ARCHS[ARCH].reduced())
    jp = jm.init(jax.random.key(0))
    pm = build_model(ARCHS[ARCH].reduced(), CPU)
    return jm, jp, bridge.lm_params_from_numpy(
        pm, jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("impl", ["ref", "chunked", "pallas"])
def test_masked_decode_matches_reference_model(rwkv, impl):
    """Reduced rwkv6-3b: a 13-token prefill of three rows, then one decode
    step with commit = [True, False, True] through each WKV route. Every
    row's logits equal the reference model's step; the committed rows'
    states equal its new states and the other row's equal its states
    before the step; the state tensors are the ones the step was given
    (written in place)."""
    jm, jp, pp = rwkv
    pm = build_model(ARCHS[ARCH].reduced().replace(attn_impl=impl), CPU)
    toks = np.random.RandomState(11).randint(0, 512, size=(3, 13)).astype(
        np.int32)
    _, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.init_states(3,
                                                                        32))
    _, ps = pm.prefill(pp, {"tokens": torch.tensor(toks)},
                       pm.init_states(3, 32))
    tok = np.array([[3], [4], [5]], np.int32)
    jl, js_new = jm.decode_step(jp, jnp.asarray(tok), js)
    seg = ps["segs"][0]
    ptrs = {(part, leaf): seg[part][leaf].data_ptr()
            for part, leaf in (("tm", "s"), ("tm", "last"), ("cm", "last"))}
    pl_, ps = pm.decode_step(pp, torch.tensor(tok), ps,
                             commit=torch.tensor([True, False, True]))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    back = bridge.lm_states_to_numpy(ps)
    for (part, leaf), ptr in ptrs.items():
        assert ps["segs"][0][part][leaf].data_ptr() == ptr
        got = back["segs"][0][part][leaf]          # [L, B, ...]
        new = np.asarray(js_new["segs"][0][part][leaf])
        old = np.asarray(js["segs"][0][part][leaf])
        np.testing.assert_allclose(got[:, [0, 2]], new[:, [0, 2]], **TOL,
                                   err_msg=f"{part}.{leaf}")
        np.testing.assert_allclose(got[:, 1], old[:, 1], **TOL,
                                   err_msg=f"{part}.{leaf}")
    np.testing.assert_array_equal(back["pos"], [14, 13, 14])
