"""The LM sharding rules, the int8 compression and the dry run against
the reference, on the CPU (no ranks: the rules read only a mesh's axis
names and sizes).

  * every leaf's spec -- parameters (``param_pspec``), ZeRO-1 moments
    (``zero1_pspec``), serving states (``states_shardings``) and batches
    (``batch_pspec``) -- equals the reference's, for all 10 architectures,
    reduced and at full width, on meshes (2, 4), (16, 16) and (2, 16, 16),
    layouts "tp" and "dp", and ``moe_impl`` "dense", "shard_map" and
    "shard_map_wg". The port side is built on the meta device; the
    reference side through ``jax.eval_shape`` and a stand-in mesh with
    ``axis_names`` and ``devices.shape``. A port leaf is one layer of
    the reference's stacked leaf: its spec is the stacked leaf's;
  * ``compress_grads`` over 5 steps of error feedback is bit-equal to
    the reference's, the residuals too;
  * the dry run's 80 cells: ``applicable``, ``_microbatch_plan`` and the
    per-rank argument bytes equal those computed from the reference's
    own specs and shapes;
  * the placements a spec turns into, and the refusal of uneven dims.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import applicable as j_applicable  # noqa: E402
from repro.distributed import compress as j_compress  # noqa: E402
from repro.distributed import sharding as j_sharding  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.models.api import input_specs as j_input_specs  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro.utils import pytree as j_pytree  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed import compress, sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.api import build_model, input_specs  # noqa: E402
from repro_torch.utils.pytree import reference_path  # noqa: E402

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MOE_ARCHS = {"qwen3-moe-235b-a22b", "arctic-480b"}


class Spec:
    """The reference's NamedSharding, reduced to its spec (a pytree
    leaf: the rules run on a mesh with no devices)."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


class DuckMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def _variants(arch):
    impls = ("dense", "shard_map", "shard_map_wg") if arch in MOE_ARCHS \
        else ("dense",)
    for reduced in (True, False):
        for layout in ("tp", "dp"):
            for impl in impls:
                yield reduced, layout, impl


def _cfg(archs, arch, reduced, **kw):
    cfg = archs[arch].reduced() if reduced else archs[arch]
    return cfg.replace(**kw)


_SHAPES = {}


def _cached(key, make):
    """The reference's shapes depend on the config, not on the mesh or
    the knobs the rules read: trace each once per process."""
    if key not in _SHAPES:
        _SHAPES[key] = make()
    return _SHAPES[key]


def _ref_param_shapes(arch, reduced):
    return _cached(("params", arch, reduced), lambda: jax.eval_shape(
        j_build(_cfg(J_ARCHS, arch, reduced)).init, jax.random.key(0)))


def _ref_specs(rule, shapes, cfg, mesh) -> dict:
    out = {}
    j_pytree.tree_map_with_path_str(
        lambda p, leaf: out.__setitem__(p, tuple(rule(p, leaf, cfg, mesh))),
        shapes)
    return out


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_moment_specs_equal_reference(arch, mesh_id):
    shape, names = MESHES[mesh_id]
    jmesh, pmesh = DuckMesh(shape, names), sharding.LogicalMesh(shape, names)
    for reduced, layout, impl in _variants(arch):
        kw = dict(layout=layout, moe_impl=impl)
        jcfg, pcfg = (_cfg(J_ARCHS, arch, reduced, **kw),
                      _cfg(ARCHS, arch, reduced, **kw))
        shapes = _ref_param_shapes(arch, reduced)
        params = build_model(pcfg, "meta").empty_params()
        port_shapes = {n: tuple(t.shape)
                       for n, t in params.named_parameters()}
        for rule, port in ((j_sharding.param_pspec,
                            sharding.params_shardings),
                           (j_sharding.zero1_pspec,
                            sharding.opt_state_shardings)):
            want = _ref_specs(rule, shapes, jcfg, jmesh)
            got = port(params, pcfg, pmesh)
            label = (arch, reduced, layout, impl, rule.__name__)
            assert {reference_path(n)[0] for n in got} == set(want), label
            for name, sh in got.items():
                path = reference_path(name)[0]
                assert tuple(sh.spec) == want[path], (label, name)
                sh.shard_shape(port_shapes[name])


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_and_batch_specs_equal_reference(arch, mesh_id,
                                               monkeypatch):
    """Serving states at each shape cell's batch (reduced: 4 rows of 64
    tokens; full width: the cell's batch and a 64-token ring, whose
    shapes the rules see the same), and every cell's batch inputs."""
    shape, names = MESHES[mesh_id]
    jmesh, pmesh = DuckMesh(shape, names), sharding.LogicalMesh(shape, names)
    monkeypatch.setattr(j_sharding, "NamedSharding", Spec)
    for reduced in (True, False):
        for seq_shard in (False, True):
            jcfg = _cfg(J_ARCHS, arch, reduced, seq_shard_cache=seq_shard)
            pcfg = _cfg(ARCHS, arch, reduced, seq_shard_cache=seq_shard)
            jm, pm = j_build(jcfg), build_model(pcfg, "meta")
            for gb in (4, 6, 32):
                want = {}
                j_pytree.tree_map_with_path_str(
                    lambda p, s: want.__setitem__(p, s.spec),
                    j_sharding.states_shardings(
                        _cached(("states", arch, reduced, gb),
                                lambda: jax.eval_shape(
                                    lambda: jm.init_states(gb, 64))),
                        jcfg, jmesh, global_batch=gb))
                got = sharding.states_shardings(
                    pm.init_states(gb, 64), pcfg, pmesh, global_batch=gb)
                assert {reference_path(n)[0]: tuple(s.spec)
                        for n, s in got.items()} == want, (arch, gb)
        for sname, cell in J_SHAPES.items():
            jcfg = _cfg(J_ARCHS, arch, reduced)
            pcfg = _cfg(ARCHS, arch, reduced)
            from repro_torch.configs import SHAPES
            for layout in ("tp", "dp"):
                want = j_sharding.batch_shardings(
                    j_input_specs(jcfg, cell), jmesh, layout=layout)
                got = sharding.batch_shardings(
                    input_specs(pcfg, SHAPES[sname]), pmesh, layout=layout)
                assert {k: tuple(v.spec) for k, v in got.items()} == {
                    k: v.spec for k, v in want.items()}


def test_spec_placements_and_uneven_dims():
    from torch.distributed.tensor import Replicate, Shard

    mesh = sharding.LogicalMesh((2, 16, 16), ("pod", "data", "model"))
    P = sharding.P
    assert sharding.spec_placements(P(("pod", "data"), None, "model"),
                                    mesh) == (Shard(0), Shard(0), Shard(2))
    assert sharding.spec_placements(P(None, None), mesh) == (
        Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        sharding.spec_placements(P(("data", "pod")), mesh)
    ns = sharding.NamedSharding(mesh, P(("pod", "data"), "model"))
    assert ns.shard_shape((64, 48)) == (2, 3)
    with pytest.raises(ValueError, match="does not split"):
        ns.shard_shape((64, 40))
    # a stacked leaf's spec on one layer: the layer axis dropped
    assert sharding.NamedSharding(mesh, P("data", None, "model")
                                  ).local_spec(2) == P(None, "model")


# -------------------------------------------------------- compression
def test_compress_grads_bit_equal_over_steps():
    rng = np.random.default_rng(0)
    shapes = {"a": (17, 5), "b": (64,), "c": (3, 4, 5)}
    g0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    j_ef = j_compress.ef_init(g0)
    p_ef = compress.ef_init({k: torch.from_numpy(v) for k, v in g0.items()})
    for step in range(5):
        scale = 10.0 ** rng.integers(-3, 3)
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        want, j_ef = j_compress.compress_grads(
            {k: jnp.asarray(v) for k, v in g.items()}, j_ef)
        got, p_ef = compress.compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, p_ef)
        for k in shapes:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
            np.testing.assert_array_equal(p_ef.residual[k].numpy(),
                                          np.asarray(j_ef.residual[k]))
    q, s = compress.quantize_int8(torch.tensor([0.5, -1.5, 2.5, 127.0]))
    assert q.dtype == torch.int8 and q.tolist() == [0, -2, 2, 127]


def test_compress_rounds_half_to_even_as_the_reference():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32) * (
        126.5 / 127.0)
    q, _ = compress.quantize_int8(torch.from_numpy(x))
    jq, _ = j_compress.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


# ------------------------------------------------------------ dry run
@pytest.fixture(scope="module")
def j_microbatch_plan():
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import _microbatch_plan   # sets XLA_FLAGS
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return _microbatch_plan


def _spec_bytes(shapes, specs, mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    for leaf, sh in zip(jax.tree_util.tree_leaves(shapes),
                        jax.tree_util.tree_leaves(specs)):
        spec = sh.spec + (None,) * (len(leaf.shape) - len(sh.spec))
        n = 1
        for dim, entry in zip(leaf.shape, spec):
            names = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            k = math.prod(sizes[a] for a in names)
            assert dim % k == 0
            n *= dim // k
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _reference_cell(arch, shape_name, multi, mb_plan, monkeypatch):
    """(status, skip_reason, microbatches, per-rank argument bytes) from
    the reference's own shapes and specs."""
    cfg = J_ARCHS[arch]
    cell = J_SHAPES[shape_name]
    ok, reason = j_applicable(cfg, cell)
    if not ok:
        return "skipped", reason, None, None
    shape, names = MESHES["2x16x16" if multi else "16x16"]
    mesh = DuckMesh(shape, names)
    cfg = cfg.replace(gqa_expand=(cfg.n_heads % 16 == 0
                                  and cfg.n_kv_heads % 16 != 0))
    monkeypatch.setattr(j_sharding, "NamedSharding", Spec)
    monkeypatch.setattr(j_step, "NamedSharding", Spec)
    model = j_build(cfg)
    batch = j_input_specs(cfg, cell)
    bsh = j_sharding.batch_shardings(batch, mesh, layout=cfg.layout)
    if cell.kind == "train":
        mb = mb_plan(cfg, cell, math.prod(shape),
                     j_sharding.data_size(mesh))
        state = _cached(("train", arch), lambda: jax.eval_shape(
            lambda k: j_step.init_train_state(model, k), jax.random.key(0)))
        ssh = j_step.train_state_shardings(state, cfg, mesh)
        nbytes = (_spec_bytes(state, ssh, mesh)
                  + _spec_bytes(batch, bsh, mesh))
        return "ok", "", mb, nbytes
    params = _cached(("cell params", arch), lambda: jax.eval_shape(
        model.init, jax.random.key(0)))
    states = _cached(("cell states", arch, shape_name), lambda: jax.eval_shape(
        lambda: model.init_states(cell.global_batch, cell.seq_len)))
    psh = j_sharding.params_shardings(params, cfg, mesh)
    ssh = j_sharding.states_shardings(states, cfg, mesh,
                                      global_batch=cell.global_batch)
    if cell.kind == "decode":
        batch, bsh = batch["token"], bsh["token"]
    return "ok", "", None, (_spec_bytes(params, psh, mesh)
                            + _spec_bytes(batch, bsh, mesh)
                            + _spec_bytes(states, ssh, mesh))


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dry_run_cells_equal_reference_specs(arch, multi, tmp_path,
                                             j_microbatch_plan,
                                             monkeypatch):
    for shape_name in J_SHAPES:
        rec = dryrun.run_cell(arch, shape_name, multi, str(tmp_path),
                              flops=False)
        status, reason, mb, nbytes = _reference_cell(
            arch, shape_name, multi, j_microbatch_plan, monkeypatch)
        assert (rec["status"], rec["skip_reason"]) == (status, reason)
        if status != "ok":
            continue
        assert rec.get("microbatches") == mb, shape_name
        assert rec["memory"]["argument_bytes"] == nbytes, shape_name
        assert rec["memory"]["temp_bytes"] is None
        assert rec["n_devices"] == (512 if multi else 256)


def test_dry_run_counts_a_reduced_steps_flops(tmp_path, monkeypatch):
    """The FLOP count runs the whole step on the meta device: a train
    cell counts the backward too (about 2x the forward; the train cell's
    head runs on every position, prefill's on the last) and, with remat,
    the layers' forward again."""
    from repro_torch.configs import SHAPES, reduced_shape
    mesh = sharding.LogicalMesh((16, 16), ("data", "model"))
    flops = {}
    for remat in (False, True):
        cfg = ARCHS["smollm-360m"].reduced().replace(remat=remat)
        for kind in ("train_4k", "prefill_32k"):
            cell = reduced_shape(SHAPES[kind])
            model, trees, _ = dryrun.cell_arguments(cfg, cell, mesh)
            flops[kind, remat] = dryrun.step_flops(model, cell, trees)
    assert flops["prefill_32k", False] == flops["prefill_32k", True]
    assert 3 < flops["train_4k", False] / flops["prefill_32k", False] < 4
    assert 1.1 < flops["train_4k", True] / flops["train_4k", False] < 1.4
