"""The port's MoE path (``models/moe.py`` and the ``moe`` layer kind)
against the JAX package's, on the CPU.

Reduced qwen3-moe-235b-a22b (8 experts, top-2, d_expert 64) and
arctic-480b (the same, with the dense-parallel SwiGLU): 2 layers,
d_model 128, vocab 512, float32. Weights come from the reference's
``init_moe`` / ``Model.init`` through the bridge; inputs are drawn with
numpy from a seed.

Tolerances, and why:
  * ``moe_layer`` outputs: ``atol=1e-5, rtol=1e-5`` (float32 GEMMs in
    another order); the dispatch is compared exactly — which pairs are
    kept (the overflow fraction) must be the reference's, since the
    capacity drops depend on the sort;
  * aux losses ``rtol=1e-5, atol=1e-6``; model logits ``atol=1e-4,
    rtol=1e-4``; loss and gradients ``rtol=1e-5, atol=1e-6``
    (test_torch_train.py's).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.utils import pytree as j_pytree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.layers import Init  # noqa: E402
from repro_torch.utils.pytree import load_leaves  # noqa: E402

CPU = "cpu"
ACT = dict(atol=1e-5, rtol=1e-5)
AUX = dict(rtol=1e-5, atol=1e-6)
LOGITS = dict(atol=1e-4, rtol=1e-4)
GRAD = dict(rtol=1e-5, atol=1e-6)
ARCHS_MOE = ["qwen3-moe-235b-a22b", "arctic-480b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree) -> dict:
    out = {}
    j_pytree.tree_map_with_path_str(
        lambda p, x: out.__setitem__(p, np.asarray(x)), tree)
    return out


def _cfgs(arch, cf=None):
    jc, pc = J_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    if cf is not None:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, capacity_factor=cf))
        pc = pc.replace(moe=dataclasses.replace(pc.moe, capacity_factor=cf))
    return jc, pc


def _layer_pair(arch, cf):
    jc, pc = _cfgs(arch, cf)
    jp = JM.init_moe(jax.random.key(1), jc)
    pp = PM.init_moe(Init(torch.device(CPU), None), pc)
    flat = _leaves(jp)
    load_leaves(pp, flat, lambda p: torch.tensor(flat[p]))
    return jc, jp, pc, pp


# capacity factors: 1.0 drops pairs (capacity int(n·k/E + 1)), 8.0 is
# dropless (the reference's prefill/decode check)
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_moe_layer_matches_reference(arch, cf):
    jc, jp, pc, pp = _layer_pair(arch, cf)
    x = (np.random.RandomState(2).randn(3, 16, 128) * 0.5).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: JM.moe_layer(p, x, jc))(jp, jnp.asarray(x))
    py, paux = PM.moe_layer(pp, torch.tensor(x), pc)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **ACT)
    assert set(paux) == set(jaux)
    for k in paux:
        assert paux[k].dtype == torch.float32 and paux[k].dim() == 0
        np.testing.assert_allclose(float(paux[k]), float(jaux[k]),
                                   err_msg=k, **AUX)
    # the same pairs kept: the overflow counts equal exactly
    n_pairs = 3 * 16 * pc.moe.top_k
    assert round(float(paux["overflow_fraction"]) * n_pairs) == \
        round(float(jaux["overflow_fraction"]) * n_pairs)
    if cf <= 1.0:
        assert float(paux["overflow_fraction"]) > 0      # drops happen
    if cf == 8.0:
        assert float(paux["overflow_fraction"]) == 0


def test_capacity_is_the_reference_formula():
    _, pc = _cfgs("qwen3-moe-235b-a22b", 1.25)
    for n in (1, 7, 48, 1000):
        assert PM.capacity(n, pc) == int(n * 2 / 8 * 1.25 + 1)


def test_dense_parallel_branch_adds_the_swiglu():
    """Arctic: the layer is the experts' output plus the dense SwiGLU's;
    without ``dense_mlp`` the same layer is the experts' alone."""
    from repro_torch.models.layers import swiglu

    jc, jp, pc, pp = _layer_pair("arctic-480b", 1.25)
    assert pp.dense_mlp is not None
    x = torch.tensor((np.random.RandomState(3).randn(2, 8, 128) * 0.5)
                     .astype(np.float32))
    full, _ = PM.moe_layer(pp, x, pc)
    dense_mlp, pp.dense_mlp = pp.dense_mlp, None
    experts, _ = PM.moe_layer(pp, x, pc)
    torch.testing.assert_close(full, experts + swiglu(dense_mlp, x),
                               atol=1e-6, rtol=1e-6)


def _model_pair(arch, cf=None, **changes):
    jc, pc = _cfgs(arch, cf)
    jm = j_build(jc.replace(**changes))
    jp = jm.init(jax.random.key(0))
    pm = build_model(pc.replace(**changes), CPU)
    return jm, jp, pm, bridge.lm_params_from_numpy(pm, _np(jp))


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_loss_aux_and_grads_match_reference(arch):
    """The default capacity (1.25, drops at this size): logits, the loss
    with its aux terms, the metrics and every gradient leaf."""
    jm, jp, pm, pp = _model_pair(arch, attn_impl="chunked")
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(0, 512, size=(2, 24)).astype(np.int32),
             "labels": rng.randint(0, 512, size=(2, 24)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: torch.tensor(v) for k, v in batch.items()}
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    pp.requires_grad_(True)
    named = dict(pp.named_parameters())
    loss, metrics = pm.loss(pp, pb)
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), **GRAD)
    assert sorted(metrics) == sorted(jmet)
    metrics = {k: float(v.detach()) for k, v in metrics.items()}
    for k in metrics:
        np.testing.assert_allclose(metrics[k], float(jmet[k]), err_msg=k,
                                   **AUX)
    assert metrics["overflow_fraction"] > 0
    got, want = _leaves(bridge.lm_params_to_numpy(dict(zip(named, grads)))), \
        _leaves(_np(jg))
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, err_msg=p, **GRAD)


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_prefill_decode_match_reference_and_train(arch):
    """Dropless capacity (8.0, as the reference's own check): prefill of
    11 tokens and a decode step equal the reference's, and the
    teacher-forced logits at those positions."""
    jm, jp, pm, pp = _model_pair(arch, 8.0)
    toks = np.random.RandomState(5).randint(0, 512, size=(2, 12)).astype(
        np.int32)
    jl, _ = jax.jit(jm.apply_train)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        pt, _ = pm.apply_train(pp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(pt.numpy(), np.asarray(jl), **LOGITS)
    js = jm.init_states(2, 28)
    jlp, js = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :11])},
                                  js)
    ps = pm.init_states(2, 28)
    plp, ps = pm.prefill(pp, {"tokens": torch.tensor(toks[:, :11])}, ps)
    jld, js = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, 11:]), js)
    pld, ps = pm.decode_step(pp, torch.tensor(toks[:, 11:]), ps)
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), **LOGITS)
    np.testing.assert_allclose(pld.numpy(), np.asarray(jld), **LOGITS)
    np.testing.assert_allclose(plp.numpy(), pt.numpy()[:, 10], atol=2e-4)
    np.testing.assert_allclose(pld.numpy(), pt.numpy()[:, 11], atol=2e-4)


def test_decode_routes_idle_rows_too():
    """A decode step computes every row: with a capacity that drops, the
    rows a ``commit`` mask leaves out still take their slots, as the
    reference's do, so every row's logits equal the reference's unmasked
    step."""
    jm, jp, pm, pp = _model_pair("qwen3-moe-235b-a22b", 0.5)
    toks = np.random.RandomState(6).randint(0, 512, size=(4, 6)).astype(
        np.int32)
    js = jm.init_states(4, 16)
    _, js = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :5])}, js)
    jld, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(toks[:, 5:]), js)
    ps = pm.init_states(4, 16)
    pm.prefill(pp, {"tokens": torch.tensor(toks[:, :5])}, ps)
    commit = torch.tensor([True, False, True, False])
    pld, _ = pm.decode_step(pp, torch.tensor(toks[:, 5:]), ps, commit=commit)
    np.testing.assert_allclose(pld.numpy(), np.asarray(jld), **LOGITS)
