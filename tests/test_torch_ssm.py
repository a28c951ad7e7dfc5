"""The port's SSD scan (``models/ssm.py``) against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed: x, B, C ~ N(0, 0.5²), dt from a
softplus of N(0, 1) (as hymba's branch makes it), a_log ~ N(0, 0.5²) and
h0 ~ N(0, 0.5²).

Tolerances, and why: ``atol=1e-5, rtol=1e-5`` on y and the state — float32
einsums summed in another order by the two frameworks (y and S are O(1)
here); the chunked scan against the per-step oracle within ``atol=1e-4,
rtol=1e-4`` (the reference's own test of the two). The in-place contract
is exact: a row outside ``commit`` keeps its bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as J  # noqa: E402
from repro_torch.models import ssm as P  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(b, t, h, p, n, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(rng.randn(b, t, h))).astype(np.float32)
    return dict(x=f(b, t, h, p), dt=dt, a_log=f(h), bmat=f(b, t, h, n),
                cmat=f(b, t, h, n)), f(b, h, p, n)


def _j(args):
    return {k: jnp.asarray(v) for k, v in args.items()}


def _p(args):
    return {k: torch.tensor(v) for k, v in args.items()}


# (B, T, H, P, N, chunk): one chunk, several, T not a multiple of the
# chunk (the chunk halves until it divides T), T = 1; two blocks of
# BLOCK_TOKENS (1,024) of chunks of 32, and of chunks of 1 (T odd)
SHAPES = [(2, 32, 3, 8, 4, 32), (1, 64, 2, 16, 8, 16), (2, 48, 4, 8, 8, 32),
          (1, 37, 2, 8, 4, 16), (2, 1, 3, 8, 4, 32), (1, 2048, 2, 4, 4, 32),
          (1, 1025, 2, 4, 4, 32)]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,t,h,p,n,chunk", SHAPES)
def test_ssd_chunked_matches_reference(b, t, h, p, n, chunk, with_h0):
    args, h0 = _inputs(b, t, h, p, n, seed=t + h)
    jy, js = jax.jit(J.ssd_chunked, static_argnames="chunk")(
        **_j(args), h0=jnp.asarray(h0) if with_h0 else None, chunk=chunk)
    py, ps = P.ssd_chunked(**_p(args), h0=torch.tensor(h0) if with_h0
                           else None, chunk=chunk)
    assert py.dtype == ps.dtype == torch.float32
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), **TOL)
    # and against the per-step oracle
    ry, rs = P.ssd_ref(**_p(args), h0=torch.tensor(h0) if with_h0 else None)
    np.testing.assert_allclose(py.numpy(), ry.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(ps.numpy(), rs.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_ref_matches_reference(with_h0):
    args, h0 = _inputs(2, 20, 3, 8, 4, seed=3)
    jy, js = jax.jit(J.ssd_ref)(**_j(args),
                                h0=jnp.asarray(h0) if with_h0 else None)
    py, ps = P.ssd_ref(**_p(args), h0=torch.tensor(h0) if with_h0 else None)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), **TOL)


def test_ssd_decode_steps_match_reference():
    """Eight decode steps from h0 against the reference's, each step's y
    and state, and their end against the chunked scan of all eight."""
    args, h0 = _inputs(3, 8, 2, 8, 4, seed=5)
    js, ps = jnp.asarray(h0), torch.tensor(h0)
    step = jax.jit(J.ssd_decode_step)
    for i in range(8):
        one = {k: v[:, i] for k, v in args.items() if k != "a_log"}
        jy, js = step(js, **_j(one), a_log=jnp.asarray(args["a_log"]))
        py, ps = P.ssd_decode_step(ps, **_p(one),
                                   a_log=torch.tensor(args["a_log"]))
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), **TOL)
    _, s_scan = P.ssd_chunked(**_p(args), h0=torch.tensor(h0), chunk=4)
    np.testing.assert_allclose(ps.numpy(), s_scan.numpy(), **SCAN_TOL)


@pytest.mark.parametrize("commit", [None, [True, False, True],
                                    [False, False, False]])
@pytest.mark.parametrize("route", ["chunked", "decode"])
def test_state_written_in_place_only_for_commit_rows(route, commit):
    """``s_out=h0`` (the serving state itself): the committed rows get the
    reference's final state, the others keep their bytes; y is every
    row's; ``commit`` without ``s_out`` is refused."""
    t = 8 if route == "chunked" else 1
    args, h0 = _inputs(3, t, 2, 8, 4, seed=7)
    state = torch.tensor(h0)
    before = state.clone()
    mask = None if commit is None else torch.tensor(commit)
    if route == "chunked":
        jy, js = J.ssd_chunked(**_j(args), h0=jnp.asarray(h0), chunk=4)
        py, out = P.ssd_chunked(**_p(args), h0=state, chunk=4, s_out=state,
                                commit=mask)
    else:
        one = {k: v[:, 0] for k, v in args.items() if k != "a_log"}
        a_log = args["a_log"]
        jy, js = J.ssd_decode_step(jnp.asarray(h0), **_j(one),
                                   a_log=jnp.asarray(a_log))
        jy = jy[:, None]
        py, out = P.ssd_decode_step(state, **_p(one),
                                    a_log=torch.tensor(a_log), s_out=state,
                                    commit=mask)
        py = py[:, None]
    assert out is state
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    rows = np.ones(3, bool) if commit is None else np.asarray(commit)
    np.testing.assert_allclose(state.numpy()[rows], np.asarray(js)[rows],
                               **TOL)
    assert torch.equal(state[torch.tensor(~rows)], before[torch.tensor(~rows)])
    with pytest.raises(ValueError, match="commit needs s_out"):
        P.ssd_chunked(**_p(args), commit=torch.ones(3, dtype=torch.bool))


def test_chunk_masks_before_the_exponential():
    """At hymba's chunk of 256 the differences of the upper triangle
    overflow float32's exponential; the port masks them first, so the
    gradient stays finite (the value equals the per-step oracle's)."""
    args, _ = _inputs(1, 256, 2, 4, 4, seed=9)
    args["dt"] = np.full_like(args["dt"], 1.5)       # Σ log a ~ -384
    args["a_log"] = np.zeros_like(args["a_log"])
    ts = {k: torch.tensor(v, requires_grad=True) for k, v in args.items()}
    y, s = P.ssd_chunked(**ts, chunk=256)
    ry, _ = P.ssd_ref(**{k: v.detach() for k, v in ts.items()})
    np.testing.assert_allclose(y.detach().numpy(), ry.numpy(), **SCAN_TOL)
    grads = torch.autograd.grad(y.sum() + s.sum(), list(ts.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
