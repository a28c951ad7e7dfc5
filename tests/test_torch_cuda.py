"""The port on the card: the hand-written kernels against their plain
PyTorch versions, bit for bit (the attachment kernel also through
``barabasi_albert`` against the CPU build), small wavefront and
wavefront_overlap runs through them against the port's oracle and its CPU run, a traced
run against the untraced one, and reduced train steps against the same
steps on the CPU, without a host sync, and the refusal to train through
the kernels (which have no backward). Every test is marked ``cuda``
and skips without a card. The file imports no JAX, so it runs on a GPU
machine that has only PyTorch (``--noconftest``: tests/conftest.py
imports JAX):

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

from conflict_cases import KINDS, block, footprint  # noqa: E402

from repro_torch.core import ProtocolConfig, run_engine, run_oracle  # noqa: E402
from repro_torch.kernels.attach import attach_arrivals  # noqa: E402
from repro_torch.kernels.attach import attach as attach_kernel  # noqa: E402
from repro_torch.kernels.axelrod import axelrod as axelrod_kernel  # noqa: E402
from repro_torch.kernels.axelrod import axelrod_wave  # noqa: E402
from repro_torch.kernels.conflict import conflict as conflict_kernel  # noqa: E402
from repro_torch.kernels.conflict.ops import (  # noqa: E402
    conflict_block,
    conflict_matrix,
)
from repro_torch.kernels.levels import levels as levels_kernel  # noqa: E402
from repro_torch.kernels.levels.ops import wave_levels  # noqa: E402
from repro_torch.kernels.sir import sir as sir_kernel  # noqa: E402
from repro_torch.kernels.sir import sir_wave  # noqa: E402
from repro_torch.mabs import (  # noqa: E402
    AxelrodConfig,
    AxelrodModel,
    SIRConfig,
    SIRModel,
    SISModel,
    VoterModel,
)
from repro_torch.obs import tracing, validate_chrome_trace  # noqa: E402
from repro_torch.topology import (  # noqa: E402
    barabasi_albert,
    erdos_renyi,
    watts_strogatz,
)
from repro_torch.utils import prng, timing  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _footprint(seed, w, nr, nw, device):
    gen = torch.Generator().manual_seed(seed)
    ids = max(4, w // 2)
    reads = torch.randint(0, ids, (w, nr), generator=gen, dtype=torch.int32)
    writes = torch.randint(0, ids, (w, nw), generator=gen, dtype=torch.int32)
    reads[torch.rand((w, nr), generator=gen) < 0.2] = -1
    writes[torch.rand((w, nw), generator=gen) < 0.2] = -1
    valid = torch.arange(w) < w - w // 7
    return reads.to(device), writes.to(device), valid.to(device)


@pytest.mark.parametrize("w", [1, 37, 129, 1000])
@pytest.mark.parametrize("nr,nw", [(1, 1), (21, 2)])
@pytest.mark.parametrize("strict", [True, False])
def test_conflict_kernel_matches_plain(cuda_device, w, nr, nw, strict):
    reads, writes, valid = _footprint(w + nr, w, nr, nw, cuda_device)
    before = conflict_kernel.launches
    got = conflict_matrix(reads, writes, valid, strict=strict)
    assert conflict_kernel.launches == before + 1
    want = conflict_matrix(reads, writes, valid, strict=strict,
                           backend="torch")
    assert torch.equal(got, want)


@pytest.mark.parametrize("w", [1, 37, 129, 1000, 4096])
@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("lower", [True, False])
def test_levels_kernel_matches_plain(cuda_device, w, with_base, lower):
    gen = torch.Generator().manual_seed(w)
    conf = torch.rand((w, w), generator=gen) < 0.02
    if lower:
        conf = conf.tril(diagonal=-1)
    valid = torch.rand(w, generator=gen) < 0.85
    base = (torch.randint(0, 4, (w,), generator=gen, dtype=torch.int32)
            if with_base else None)
    conf, valid = conf.to(cuda_device), valid.to(cuda_device)
    base = None if base is None else base.to(cuda_device)
    before = levels_kernel.launches
    got = wave_levels(conf, valid, base=base)
    assert levels_kernel.launches == before + 1
    assert torch.equal(got, wave_levels(conf, valid, base=base,
                                        backend="torch"))


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    reads, writes, valid = _footprint(0, 64, 3, 1, cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        conflict_kernel.conflict_matrix_cuda(reads.long(), writes, valid)
    with pytest.raises(ValueError, match="contiguous"):
        conflict_kernel.conflict_matrix_cuda(reads.t().contiguous().t(),
                                             writes, valid)
    conf = torch.zeros((64, 64), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        levels_kernel.wave_levels_cuda(conf, valid[:10])


@pytest.mark.parametrize("w", [8193, 16384])
@pytest.mark.parametrize("with_base", [False, True])
def test_levels_kernel_past_8192_matches_plain(cuda_device, w, with_base):
    """Windows the first kernel refused (its level vector lived in 32 KB
    of shared memory); the reference takes any window."""
    gen = torch.Generator(device=cuda_device).manual_seed(w)
    conf = (torch.rand((w, w), generator=gen, device=cuda_device)
            < 2e-4).tril(diagonal=-1)
    valid = torch.arange(w, device=cuda_device) < w - w // 7
    base = (torch.randint(0, 4, (w,), generator=gen, dtype=torch.int32,
                          device=cuda_device) if with_base else None)
    before = levels_kernel.launches
    got = levels_kernel.wave_levels_cuda(conf, valid, base)
    assert levels_kernel.launches == before + 1
    assert torch.equal(got, wave_levels(conf, valid, base=base,
                                        backend="torch"))


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("padded", [False, True])
def test_conflict_kernels_wide_footprint_match_plain(cuda_device, nw, strict,
                                                     padded):
    """Footprints past the first kernels' 192 slots, which they refused;
    the reference takes any width. nr = 600 random slots, or SIS's layout
    on a hub graph: nr = 3057, each row unused past a prefix of 1..12
    slots but 2 % of the rows using every slot."""
    gen = torch.Generator().manual_seed(600 + nw + 10 * padded)
    w = 200
    nr, ids = (3057, 4 * w) if padded else (600, 8 * 600 * nw)
    reads = torch.randint(0, ids, (w, nr), generator=gen, dtype=torch.int32)
    writes = torch.randint(0, ids, (w, nw), generator=gen, dtype=torch.int32)
    reads[torch.rand((w, nr), generator=gen) < 0.2] = -1
    if padded:
        used = torch.randint(1, 13, (w, 1), generator=gen)
        used[torch.rand((w, 1), generator=gen) < 0.02] = nr
        reads[torch.arange(nr)[None, :] >= used] = -1
    valid = torch.arange(w) < w - w // 7
    reads, writes, valid = (x.to(cuda_device) for x in (reads, writes, valid))
    before = conflict_kernel.launches
    got = conflict_matrix(reads, writes, valid, strict=strict)
    assert conflict_kernel.launches == before + 1
    assert torch.equal(got, conflict_matrix(reads, writes, valid,
                                            strict=strict, backend="torch"))
    narrow_r, narrow_w, narrow_v = _footprint(nw, 77, 3, 1, cuda_device)
    for args in ((reads, writes, narrow_r, narrow_w, valid, narrow_v),
                 (narrow_r, narrow_w, reads, writes, narrow_v, valid)):
        before = conflict_kernel.block_launches
        got = conflict_block(*args, strict=strict)
        assert conflict_kernel.block_launches == before + 1
        assert torch.equal(got, conflict_block(*args, strict=strict,
                                               backend="torch"))


@pytest.mark.parametrize("engine", ["wavefront", "wavefront_overlap"])
def test_window_past_8192_on_card_matches_oracle(cuda_device, engine):
    """run_engine at W = 16384 (the levels kernel once per window), which
    the first levels kernel refused: the final state equals the oracle."""
    topo = watts_strogatz(50_000, 6, 0.1, prng.key(4, device=cuda_device),
                          device=cuda_device)
    model = VoterModel(topo)
    state0 = model.init_state(prng.key(5, device=cuda_device),
                              device=cuda_device)
    cfg = ProtocolConfig(window=16384)
    total = 16384 + 1000
    levels_kernel.launches = 0
    out, stats = run_engine(model, state0, total, seed=6, config=cfg,
                            engine=engine, device=cuda_device)
    assert levels_kernel.launches == stats["n_windows"] == 2
    oracle = run_oracle(model, state0, total, seed=6, config=cfg,
                        device=cuda_device)
    for k in out:
        assert torch.equal(out[k], oracle[k])


@pytest.mark.parametrize("cls", [VoterModel, SISModel])
def test_wavefront_on_card_matches_oracle_and_cpu(cuda_device, cls):
    """A partial-tail run through both kernels: the final state equals
    the port's oracle on the card and a CPU run; the stats equal the CPU
    run's; each kernel launched once per window."""
    topo = watts_strogatz(3000, 6, 0.1, prng.key(4, device=cuda_device),
                          device=cuda_device)
    model = cls(topo)
    state0 = model.init_state(prng.key(5, device=cuda_device),
                              device=cuda_device)
    cfg = ProtocolConfig(window=256)
    total = 256 * 6 + 100
    conflict_kernel.launches = levels_kernel.launches = 0
    out, stats = run_engine(model, state0, total, seed=6, config=cfg,
                            device=cuda_device)
    assert conflict_kernel.launches == levels_kernel.launches \
        == stats["n_windows"] == 7
    oracle = run_oracle(model, state0, total, seed=6, config=cfg,
                        device=cuda_device)
    cpu_model = cls(topo.to("cpu"))
    cpu_out, cpu_stats = run_engine(
        cpu_model, {k: v.cpu() for k, v in state0.items()}, total, seed=6,
        config=cfg, device="cpu")
    assert cpu_stats == stats
    for k in out:
        assert torch.equal(out[k], oracle[k])
        assert torch.equal(out[k].cpu(), cpu_out[k])


@pytest.mark.parametrize("wi,wj", [(1, 1), (37, 129), (1000, 37)])
@pytest.mark.parametrize("slots_i,slots_j", [((1, 1), (1, 1)),
                                             ((21, 2), (1, 1)),
                                             ((1, 1), (21, 2))])
@pytest.mark.parametrize("strict", [True, False])
def test_block_kernel_matches_plain(cuda_device, wi, wj, slots_i, slots_j,
                                    strict):
    ri, wri, vi = _footprint(wi + slots_i[0], wi, *slots_i, cuda_device)
    rj, wrj, vj = _footprint(wj + slots_j[1], wj, *slots_j, cuda_device)
    args = (ri, wri, rj, wrj, vi, vj)
    before = conflict_kernel.block_launches
    got = conflict_block(*args, strict=strict)
    assert conflict_kernel.block_launches == before + 1
    assert got.shape == (wi, wj)
    assert torch.equal(got, conflict_block(*args, strict=strict,
                                           backend="torch"))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("w", [37, 129, 4096])
def test_conflict_kernel_matches_plain_on_hard_inputs(cuda_device, kind,
                                                      strict, w):
    """The inputs hardest for a join over the ids (conflict_cases.py), as
    test_torch_conflict.py holds the plain version to the reference."""
    reads, writes, valid = (torch.as_tensor(x).to(cuda_device)
                            for x in footprint(kind, w, 3, 2, seed=w))
    before = conflict_kernel.launches
    got = conflict_matrix(reads, writes, valid, strict=strict)
    assert conflict_kernel.launches == before + 1
    assert torch.equal(got, conflict_matrix(reads, writes, valid,
                                            strict=strict, backend="torch"))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("wi,wj", [(37, 129), (129, 37), (4096, 1000)])
def test_block_kernel_matches_plain_on_hard_inputs(cuda_device, kind, strict,
                                                   wi, wj):
    args = tuple(torch.as_tensor(x).to(cuda_device)
                 for x in block(kind, wi, wj, seed=wi))
    before = conflict_kernel.block_launches
    got = conflict_block(*args, strict=strict)
    assert conflict_kernel.block_launches == before + 1
    assert got.shape == (wi, wj)
    assert torch.equal(got, conflict_block(*args, strict=strict,
                                           backend="torch"))


def test_block_kernel_refuses_what_it_does_not_take(cuda_device):
    ri, wri, vi = _footprint(0, 64, 3, 1, cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        conflict_kernel.conflict_block_cuda(ri.long(), wri, ri, wri, vi, vi)
    with pytest.raises(ValueError, match="shape"):
        conflict_kernel.conflict_block_cuda(ri, wri, ri, wri, vi, vi[:10])
    with pytest.raises(ValueError, match="contiguous"):
        conflict_kernel.conflict_block_cuda(ri.t().contiguous().t(), wri, ri,
                                            wri, vi, vi)


def _count_waves(model):
    """Count the model's execute_wave calls: [n]."""
    calls = [0]
    execute_wave = model.execute_wave

    def counted(*args, **kwargs):
        calls[0] += 1
        return execute_wave(*args, **kwargs)

    model.execute_wave = counted
    return calls


def _small_models(device):
    topo = watts_strogatz(3000, 6, 0.1, prng.key(4, device=device),
                          device=device)
    return {"voter": VoterModel(topo), "sis": SISModel(topo),
            "axelrod": AxelrodModel(AxelrodConfig(n_agents=3000),
                                    device=device),
            "sirs": SIRModel(SIRConfig(n_agents=3000, k=14,
                                       subset_size=50), device=device)}


def _on_cpu(name, model):
    if name == "voter":
        return VoterModel(model.topology.to("cpu"))
    if name == "sis":
        return SISModel(model.topology.to("cpu"))
    if name == "axelrod":
        return AxelrodModel(model.cfg, device="cpu")
    return SIRModel(model.cfg, topology=model.topology.to("cpu"))


@pytest.mark.parametrize("name", ["voter", "sis", "axelrod", "sirs"])
def test_overlap_on_card_matches_oracle_and_cpu(cuda_device, name):
    """A partial-tail overlapped run: the final state equals the port's
    oracle on the card and a CPU run; the stats equal the CPU run's;
    conflict and levels launched once per window, the block kernel once
    per boundary."""
    model = _small_models(cuda_device)[name]
    state0 = model.init_state(prng.key(5, device=cuda_device),
                              device=cuda_device)
    cfg = ProtocolConfig(window=256)
    total = 256 * 6 + 100
    waves = _count_waves(model)
    conflict_kernel.launches = conflict_kernel.block_launches = 0
    levels_kernel.launches = 0
    axelrod_kernel.launches = sir_kernel.launches = 0
    out, stats = run_engine(model, state0, total, seed=6, config=cfg,
                            engine="wavefront_overlap", device=cuda_device)
    assert conflict_kernel.launches == levels_kernel.launches \
        == stats["n_windows"] == 7
    assert conflict_kernel.block_launches == 6
    # the wave kernels: once per execute_wave call of their model
    assert axelrod_kernel.launches == (waves[0] if name == "axelrod" else 0)
    assert sir_kernel.launches == (waves[0] if name == "sirs" else 0)
    assert stats["total_waves"] <= waves[0] <= 2 * stats["total_waves"]
    oracle = run_oracle(model, state0, total, seed=6, config=cfg,
                        device=cuda_device)
    cpu_out, cpu_stats = run_engine(
        _on_cpu(name, model), {k: v.cpu() for k, v in state0.items()},
        total, seed=6, config=cfg, engine="wavefront_overlap", device="cpu")
    assert cpu_stats == stats
    for k in out:
        assert torch.equal(out[k], oracle[k])
        assert torch.equal(out[k].cpu(), cpu_out[k])


def _axelrod_inputs(seed, w, f, device):
    """Traits over 3 values, one row with every feature equal, uniforms
    on a grid of quarters (ties in the pick and the gate)."""
    gen = torch.Generator().manual_seed(seed)
    s = torch.randint(0, 3, (w, f), generator=gen, dtype=torch.int32)
    t = torch.randint(0, 3, (w, f), generator=gen, dtype=torch.int32)
    t[0] = s[0]
    u = torch.randint(0, 4, (w,), generator=gen) / 4
    g = torch.randint(0, 4, (w, f), generator=gen) / 4
    m = torch.rand(w, generator=gen) < (0.2, 0.7, 1.0)[seed % 3]
    return tuple(x.to(device) for x in (s, t, u, g, m))


@pytest.mark.parametrize("w", [1, 37, 4096])
@pytest.mark.parametrize("f", [1, 3, 37, 500])
@pytest.mark.parametrize("omega", [0.95, 0.3])
def test_axelrod_kernel_matches_plain(cuda_device, w, f, omega):
    args = _axelrod_inputs(w + f, w, f, cuda_device)
    before = axelrod_kernel.launches
    got_t, got_i = axelrod_wave(*args, omega=omega)
    assert axelrod_kernel.launches == before + 1
    want_t, want_i = axelrod_wave(*args, omega=omega, backend="torch")
    assert torch.equal(got_t, want_t) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("w,s_sz,k,n", [(1, 10, 6, 40), (37, 50, 14, 4000),
                                        (8, 1000, 14, 1_000_000),
                                        (4096, 25, 2, 4000),
                                        # a window past the threshold table
                                        (37, 10, 2100, 5000)])
def test_sir_kernel_matches_plain(cuda_device, w, s_sz, k, n):
    gen = torch.Generator().manual_seed(w + s_sz)
    states = torch.randint(0, 3, (n,), generator=gen).to(torch.int8)
    subsets = torch.randint(0, n // s_sz, (w,), generator=gen,
                            dtype=torch.int32)
    subsets[0], subsets[-1] = 0, n // s_sz - 1  # both ends wrap
    u = torch.rand((w, s_sz), generator=gen)
    args = tuple(x.to(cuda_device) for x in (states, subsets, u))
    kw = dict(n_agents=n, k=k, subset_size=s_sz, p_si=.8, p_ir=.1, p_rs=.3)
    before = sir_kernel.launches
    got = sir_wave(*args, **kw)
    assert sir_kernel.launches == before + 1
    assert torch.equal(got, sir_wave(*args, backend="torch", **kw))


@pytest.mark.parametrize("fill", ["random", "all I"])
@pytest.mark.parametrize("end", ["first", "last"])
@pytest.mark.parametrize("s_sz,k", [(10, 6), (25, 2), (50, 14)])
@pytest.mark.parametrize("n", [4000, 4003])
def test_sir_kernel_matches_plain_at_the_ring_ends(cuda_device, n, s_sz, k,
                                                   end, fill):
    """W = 1 at the first or the last subset (the halo crosses the ring's
    end; at N = 4003 its second range is not 16-byte aligned), s not a
    multiple of 4 (rows of uniforms not 16-byte aligned), random states
    or every agent infected."""
    gen = torch.Generator().manual_seed(n + s_sz)
    states = torch.randint(0, 3, (n,), generator=gen).to(torch.int8)
    if fill == "all I":
        states.fill_(1)
    b = 0 if end == "first" else n // s_sz - 1
    subsets = torch.tensor([b], dtype=torch.int32)
    u = torch.rand((1, s_sz), generator=gen)
    args = tuple(x.to(cuda_device) for x in (states, subsets, u))
    kw = dict(n_agents=n, k=k, subset_size=s_sz, p_si=.8, p_ir=.1, p_rs=.3)
    before = sir_kernel.launches
    got = sir_wave(*args, **kw)
    assert sir_kernel.launches == before + 1
    assert torch.equal(got, sir_wave(*args, backend="torch", **kw))


def test_wave_kernels_refuse_what_they_do_not_take(cuda_device):
    s, t, u, g, m = _axelrod_inputs(0, 64, 3, cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        axelrod_kernel.axelrod_wave_cuda(s.long(), t, u, g, m, omega=0.9)
    with pytest.raises(ValueError, match="shape"):
        axelrod_kernel.axelrod_wave_cuda(s, t, u[:10], g, m, omega=0.9)
    states = torch.zeros(40, dtype=torch.int8, device=cuda_device)
    subsets = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    uu = torch.zeros((4, 36), device=cuda_device)
    with pytest.raises(ValueError, match="s \\+ k <= N"):
        sir_kernel.sir_wave_cuda(states, subsets, uu, k=6, p_si=.8,
                                 p_ir=.1, p_rs=.3)
    with pytest.raises(TypeError, match="dtype"):
        sir_kernel.sir_wave_cuda(states.int(), subsets, uu[:, :10], k=6,
                                 p_si=.8, p_ir=.1, p_rs=.3)


def test_block_all_fences_the_card(cuda_device, monkeypatch):
    calls = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev) or sync(dev))
    out = {"a": torch.ones(4, device=cuda_device),
           "b": (torch.zeros(2, device=cuda_device), torch.ones(3), 1)}
    assert timing.block_all(out) is out
    assert calls == [cuda_device]
    assert timing.cuda_event_ms(lambda: out["a"] * 2, reps=3) >= 0.0


@pytest.mark.parametrize("name", ["axelrod", "sirs"])
def test_traced_run_on_card_equals_untraced(cuda_device, name):
    model = _small_models(cuda_device)[name]
    state0 = model.init_state(prng.key(5, device=cuda_device),
                              device=cuda_device)
    cfg = ProtocolConfig(window=256)
    plain, plain_stats = run_engine(model, state0, 256 * 4, seed=6,
                                    config=cfg, engine="wavefront_overlap",
                                    device=cuda_device)
    with tracing() as tr:
        out, stats = run_engine(model, state0, 256 * 4, seed=6, config=cfg,
                                engine="wavefront_overlap",
                                device=cuda_device)
    assert stats == plain_stats
    for k in out:
        assert torch.equal(out[k], plain[k])
    events = tr.export()["traceEvents"]
    validate_chrome_trace(events)
    spans = [e["name"] for e in events if e["ph"] == "B"]
    assert spans.count("schedule") == spans.count("execute") == 4
    assert spans.count("boundary") == 3
    waves = [e for e in events if e["name"] == "wave"]
    assert sum(e["args"]["width"] for e in waves) == 256 * 4


# ------------------------------------------------------- flash and the LM
FLASH_CASES = [  # b, h, hkv, t, s, d, causal, window
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 128, 256, 64, True, None),
    (2, 4, 2, 256, 256, 64, True, 128),
    (1, 2, 1, 128, 128, 128, False, None),
    (1, 4, 4, 256, 256, 32, True, 64),
    (1, 15, 5, 300, 300, 64, True, None),     # smollm heads, ragged T
    (1, 4, 1, 77, 301, 120, True, 100),       # D = 120, S > T, window
    (2, 3, 3, 1, 33, 16, True, None),         # one query (decode shape)
    (1, 2, 2, 5, 5, 8, False, 2),             # a window without causal
    (1, 16, 16, 600, 512, 64, False, None),   # T > S: cross-attention
    (2, 4, 2, 97, 33, 32, False, None),       # T > S, ragged tiles
    (1, 2, 1, 200, 2, 128, False, None),      # T > S, two keys
]


@pytest.fixture
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 1e-4),
                                             (torch.bfloat16, 2e-3, 1e-2)])
@pytest.mark.parametrize("scale", [0.3, 1.0])
@pytest.mark.parametrize("b,h,hkv,t,s,d,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda_device, no_tf32, dtype, atol, rtol,
                                    scale, b, h, hkv, t, s, d, causal,
                                    window):
    """The kernel against ``attention_ref`` on the same tensors, inputs of
    std 0.3 (a flat softmax) and 1 (a peaked one): float32 within the
    reference's flash tolerance; bfloat16 within atol 2e-3 / rtol 1e-2,
    which one bf16 rounding of the output (at most 2^-8 of it) fits."""
    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.kernels.flash.ops import flash_attention
    from repro_torch.kernels.flash.ref import attention_ref

    gen = torch.Generator().manual_seed(t * 7 + s)
    q, k, v = (torch.randn(sh, generator=gen) * scale
               for sh in ((b, h, t, d), (b, hkv, s, d), (b, hkv, s, d)))
    q, k, v = (x.to(cuda_device, dtype) for x in (q, k, v))
    n0 = flash_kernel.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_kernel.launches == n0 + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("b,h,hkv,t,s,d,causal,window", FLASH_CASES)
def test_flash_bf16_tolerance_rejects_uniform_weights(cuda_device, no_tf32,
                                                      b, h, hkv, t, s, d,
                                                      causal, window):
    """On peaked inputs (std 1) the bfloat16 tolerance above rejects
    attention with uniform weights (q = 0): a kernel that mis-weighted
    its keys would fail it."""
    from repro_torch.kernels.flash.ref import attention_ref

    gen = torch.Generator().manual_seed(t * 7 + s)
    q, k, v = (torch.randn(sh, generator=gen).to(cuda_device, torch.bfloat16)
               for sh in ((b, h, t, d), (b, hkv, s, d), (b, hkv, s, d)))
    want = attention_ref(q, k, v, causal=causal, window=window).float()
    flat = attention_ref(torch.zeros_like(q), k, v, causal=causal,
                         window=window).float()
    assert bool(((flat - want).abs() > 2e-3 + 1e-2 * want.abs()).any())


def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.flash.flash import flash_attention_cuda

    def qkv(t, s, d, dtype=torch.float32):
        return (torch.zeros((2, t, d), dtype=dtype, device=cuda_device),
                torch.zeros((1, s, d), dtype=dtype, device=cuda_device),
                torch.zeros((1, s, d), dtype=dtype, device=cuda_device))

    kw = dict(n_q_heads=2, n_kv_heads=1, causal=True, window=None,
              scale=0.125)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(*qkv(4, 4, 129), **kw)
    with pytest.raises(ValueError, match="T > S is taken without a mask"):
        flash_attention_cuda(*qkv(5, 4, 16), **kw)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_cuda(*qkv(4, 4, 16, torch.float16), **kw)
    with pytest.raises(ValueError, match="heads"):
        flash_attention_cuda(*qkv(4, 4, 16), **{**kw, "n_kv_heads": 2})


def test_serving_on_card_matches_sequential_through_flash(cuda_device,
                                                          no_tf32):
    """Reduced smollm on the card: the engine's tokens equal sequential
    decoding whose one-shot prefill runs through the flash kernel (one
    launch per layer and request); the engine launches the levels kernel
    once per iteration."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("smollm-360m").reduced()
    model = build_model(cfg, cuda_device)
    params = model.init(0, device=cuda_device)
    seq = build_model(cfg.replace(attn_impl="pallas"), cuda_device)
    rng = __import__("numpy").random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype("int32")
               for n in (5, 9, 70, 3)]
    n0 = flash_kernel.launches
    refs = []
    for p in prompts:
        st = seq.init_states(1, 96)
        lg, st = seq.prefill(params, {"tokens": torch.tensor(
            p, device=cuda_device)[None]}, st)
        toks = [int(lg[0].argmax())]
        for _ in range(5):
            lg, st = seq.decode_step(params, torch.tensor(
                [[toks[-1]]], dtype=torch.int32, device=cuda_device), st)
            toks.append(int(lg[0].argmax()))
        refs.append(toks)
    assert flash_kernel.launches - n0 == cfg.n_layers * len(prompts)
    levels_kernel.launches = 0
    eng = ServingEngine(model, params, n_slots=3, max_len=96,
                        prefill_chunk=16, device=cuda_device)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert [r.out_tokens for r in done] == refs
    assert levels_kernel.launches == eng.iterations


# ------------------------------------------------------- wkv6 and RWKV6
WKV6_CASES = [  # b, h, t, d
    (1, 2, 128, 64), (2, 3, 256, 64), (1, 1, 64, 128), (1, 2, 32, 64),
    (1, 40, 300, 64),                         # rwkv6-3b's heads, ragged T
    (2, 3, 37, 48),                           # D not a multiple of 32
    (2, 3, 37, 64),
    (8, 4, 1, 64),                            # a decode step
    (1, 2, 129, 96),
    # the kernels' edges: D padded to 32 and at its limit, T at the short
    # kernel's limit (8) and at +-1 of the 16-step tile, odd B·H
    (2, 3, 37, 1), (2, 3, 37, 33), (1, 4, 129, 100), (8, 4, 1, 128),
    (1, 40, 8, 64), (1, 40, 9, 64), (1, 40, 15, 64), (1, 40, 16, 64),
    (1, 40, 17, 64), (1, 41, 33, 64), (3, 7, 3, 64),
]
#: float32 sums of D products in another order than the plain version's
WKV6_TOL = dict(atol=1e-4, rtol=1e-4)


def _wkv6_inputs(b, h, t, d, dtype, device, *, s0, near_one):
    gen = torch.Generator().manual_seed(b * 1000 + t + d)
    f = lambda *sh: torch.randn(sh, generator=gen) * 0.4  # noqa: E731
    r, k, v = f(b, h, t, d), f(b, h, t, d), f(b, h, t, d)
    logit = f(b, h, t, d) - (5.0 if near_one else 0.0)
    w = torch.exp(-torch.exp(logit))     # decays near 1, or over (0, 1)
    u = f(h, d)
    state = f(b, h, d, d) if s0 else None
    return ([x.to(device, dtype) for x in (r, k, v, w)] + [u.to(device)],
            None if state is None else state.to(device))


@pytest.mark.parametrize("near_one", [False, True])
@pytest.mark.parametrize("s0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,d", WKV6_CASES)
def test_wkv6_kernel_matches_plain(cuda_device, dtype, s0, near_one, b, h,
                                   t, d):
    """The kernel against the plain recurrence on the same tensors (bf16
    inputs are read as float32 by both, so one tolerance holds)."""
    from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    args, state = _wkv6_inputs(b, h, t, d, dtype, cuda_device, s0=s0,
                               near_one=near_one)
    n0 = wkv6_kernel.launches
    o, sf = wkv6(*args, s0=state)
    want_o, want_s = wkv6_ref(*args, s0=state)
    torch.cuda.synchronize()
    assert wkv6_kernel.launches == n0 + 1
    assert o.dtype == sf.dtype == torch.float32
    torch.testing.assert_close(o, want_o, **WKV6_TOL)
    torch.testing.assert_close(sf, want_s, **WKV6_TOL)


@pytest.mark.parametrize("mask", ["partial", "all", "none", None])
@pytest.mark.parametrize("alias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,d", [(8, 4, 1, 64), (3, 5, 17, 33),
                                     (2, 3, 130, 128)])
def test_wkv6_kernel_writes_state_in_place(cuda_device, b, h, t, d, dtype,
                                           alias, mask):
    """``s_out`` (s0 itself, or another tensor) under a ``commit`` mask:
    one launch; the committed rows' state equals the plain version's
    within tolerance, the other rows are exactly what s_out held."""
    from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    args, state = _wkv6_inputs(b, h, t, d, dtype, cuda_device, s0=True,
                               near_one=False)
    commit = {"partial": torch.arange(b) % 2 == 1,
              "all": torch.ones(b, dtype=torch.bool),
              "none": torch.zeros(b, dtype=torch.bool), None: None}[mask]
    commit = None if commit is None else commit.to(cuda_device)
    rows = (torch.ones(b, dtype=torch.bool, device=cuda_device)
            if commit is None else commit)
    want_o, want_s = wkv6_ref(*args, s0=state)
    out = state if alias else torch.full_like(state, 7.0)
    before = out.clone()
    n0 = wkv6_kernel.launches
    o, sf = wkv6(*args, s0=state, s_out=out, commit=commit)
    torch.cuda.synchronize()
    assert wkv6_kernel.launches == n0 + 1 and sf is out
    torch.testing.assert_close(o, want_o, **WKV6_TOL)
    torch.testing.assert_close(out[rows], want_s[rows], **WKV6_TOL)
    assert torch.equal(out[~rows], before[~rows])


def test_wkv6_kernel_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.wkv6.wkv6 import wkv6_cuda

    def rkvw(t, d, dtype=torch.float32):
        return [torch.zeros((2, t, d), dtype=dtype, device=cuda_device)] * 4

    u = torch.zeros((2, 16), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        wkv6_cuda(*rkvw(4, 129), torch.zeros((2, 129), device=cuda_device),
                  n_heads=2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wkv6_cuda(*rkvw(4, 16, torch.float16), u, n_heads=2)
    with pytest.raises(ValueError, match="heads"):
        wkv6_cuda(*rkvw(4, 16), u, n_heads=3)
    with pytest.raises(ValueError, match="T >= 1"):
        wkv6_cuda(*rkvw(0, 16), u, n_heads=2)
    with pytest.raises(ValueError, match="s0"):
        wkv6_cuda(*rkvw(4, 16), u, n_heads=2,
                  s0=torch.zeros((2, 16, 8), device=cuda_device))
    s = torch.zeros((2, 16, 16), device=cuda_device)
    with pytest.raises(ValueError, match="s_out"):
        wkv6_cuda(*rkvw(4, 16), u, n_heads=2, s_out=s[:, :8])
    with pytest.raises(ValueError, match="commit needs s_out"):
        wkv6_cuda(*rkvw(4, 16), u, n_heads=2,
                  commit=torch.ones(1, dtype=torch.bool, device=cuda_device))
    with pytest.raises(TypeError, match="commit"):
        wkv6_cuda(*rkvw(4, 16), u, n_heads=2, s_out=s,
                  commit=torch.ones(1, dtype=torch.int32, device=cuda_device))


def test_rwkv_serving_on_card_matches_sequential_through_wkv6(cuda_device,
                                                              no_tf32):
    """Reduced rwkv6-3b on the card through the kernel: the engine's
    tokens equal sequential decoding, and the kernel launches once per
    layer and time-mix (prefill chunk, decode wave or decode step)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("rwkv6-3b").reduced().replace(attn_impl="pallas")
    model = build_model(cfg, cuda_device)
    params = model.init(0, device=cuda_device)
    rng = __import__("numpy").random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype("int32")
               for n in (5, 9, 70, 3)]
    n0 = wkv6_kernel.launches
    refs = []
    for p in prompts:
        st = model.init_states(1, 96)
        lg, st = model.prefill(params, {"tokens": torch.tensor(
            p, device=cuda_device)[None]}, st)
        toks = [int(lg[0].argmax())]
        for _ in range(5):
            lg, st = model.decode_step(params, torch.tensor(
                [[toks[-1]]], dtype=torch.int32, device=cuda_device), st)
            toks.append(int(lg[0].argmax()))
        refs.append(toks)
    assert wkv6_kernel.launches - n0 == cfg.n_layers * len(prompts) * 6
    waves = []
    real = ServingEngine._exec_decode_wave

    def counted(self, tasks):
        waves.append(len(tasks))
        return real(self, tasks)

    eng = ServingEngine(model, params, n_slots=3, max_len=96,
                        prefill_chunk=16, device=cuda_device)
    eng._exec_decode_wave = counted.__get__(eng)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    n0 = wkv6_kernel.launches
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert wkv6_kernel.launches - n0 == cfg.n_layers * (
        eng.prefill_tasks + len(waves))
    assert [r.out_tokens for r in done] == refs


# ------------------------------------------------ the sharded engines, NCCL
SCHEDULE_KEYS = ("total_tasks", "n_windows", "total_waves",
                 "mean_parallelism", "overlap", "n_boundaries",
                 "mean_overlap_depth", "max_overlap_depth",
                 "overlap_tasks_early", "carry_frontier_mean",
                 "carry_frontier_max")


@pytest.fixture
def nccl_world_one(cuda_device, tmp_path):
    """The default process group: NCCL, one rank on the card (NCCL puts
    no two ranks on one GPU)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("engine", ["sharded", "sharded_window_halo",
                                    "sharded_replicated", "sharded_overlap"])
@pytest.mark.parametrize("name", ["voter", "sis", "axelrod", "sirs"])
def test_sharded_world_one_nccl_equals_wavefront(cuda_device, nccl_world_one,
                                                 name, engine):
    """Each sharded engine at world size 1 under NCCL (the default group,
    found by the engine) equals ``wavefront`` / ``wavefront_overlap`` on
    the card: state, schedule stats, kernel launches; its collective call
    sites count ``comm_bytes_total``."""
    from repro_torch.engine import make_engine

    model = _small_models(cuda_device)[name]
    state0 = model.init_state(prng.key(5, device=cuda_device),
                              device=cuda_device)
    total = 256 * 6 + 100
    overlap = engine == "sharded_overlap"
    wf, wf_stats = make_engine(
        "wavefront_overlap" if overlap else "wavefront", model,
        window=256, device=cuda_device).run(state0, total, seed=6)
    waves = _count_waves(model)
    conflict_kernel.launches = conflict_kernel.block_launches = 0
    levels_kernel.launches = 0
    axelrod_kernel.launches = sir_kernel.launches = 0
    eng = make_engine(engine, model, window=256)
    assert eng.agents.group is nccl_world_one
    assert eng.device == cuda_device
    out, stats = eng.run(state0, total, seed=6)
    assert conflict_kernel.launches == levels_kernel.launches == 7
    assert conflict_kernel.block_launches == (6 if overlap else 0)
    assert axelrod_kernel.launches == (waves[0] if name == "axelrod" else 0)
    assert sir_kernel.launches == (waves[0] if name == "sirs" else 0)
    for k in out:
        assert torch.equal(out[k], wf[k])
    assert {k: stats.get(k) for k in SCHEDULE_KEYS} == \
        {k: wf_stats.get(k) for k in SCHEDULE_KEYS}
    assert stats["n_devices"] == 1
    assert eng.agents.comm_bytes == stats["comm_bytes_total"] > 0


@pytest.mark.parametrize("engine", ["sharded", "sharded_overlap"])
def test_sharded_world_of_one_on_card_equals_wavefront(cuda_device, engine):
    """Without a process group the engine is a world of one: no
    collective, the same state as the wavefront engines on the card."""
    from repro_torch.engine import make_engine

    model = _small_models(cuda_device)["sis"]
    state0 = model.init_state(prng.key(5, device=cuda_device),
                              device=cuda_device)
    out, stats = make_engine(engine, model, window=256).run(state0, 1636,
                                                            seed=6)
    wf, _ = make_engine(engine.replace("sharded", "wavefront"), model,
                        window=256, device=cuda_device).run(state0, 1636,
                                                            seed=6)
    assert stats["n_devices"] == 1 and stats["halo_split"]
    assert torch.equal(out["states"], wf["states"])


# ------------------------------------------------- the attachment kernel
def _grown_ends(m, arrivals, device, room=600):
    """A multiset after a seed clique and ``arrivals`` exact arrivals
    (the plain version on the CPU), with room for ``room`` more."""
    seed = torch.triu_indices(m + 1, m + 1, 1)
    fill = (m + 1) * m
    ends = torch.zeros(fill + 2 * m * (arrivals + room), dtype=torch.int32)
    ends[:fill] = torch.cat([seed[0], seed[1]])
    attach_arrivals(prng.key(2, device="cpu"), ends, first=m + 1,
                    count=arrivals, fill=fill, m=m)
    return ends.to(device), fill + 2 * m * arrivals, m + 1 + arrivals


#: (warm, block) of one call: exact, one frozen block, an exact warm-up
#: then frozen blocks (600 arrivals: 100 + 7 blocks of 64 + 52 of an 8th)
ATTACH_MODES = {"exact": (None, None), "frozen": (0, None),
                "chunked": (100, 64)}


def _attach_both(key, ends, first, count, fill, m, mode="exact"):
    """(kernel's targets, its multiset, plain targets, plain multiset) of
    one call on copies of ``ends``; the kernel's is one launch."""
    warm, block = ATTACH_MODES[mode]
    got_ends, want_ends = ends.clone(), ends.clone()
    before = attach_kernel.launches
    got = attach_arrivals(key, got_ends, first=first, count=count,
                          fill=fill, m=m, warm=warm, block=block,
                          backend="cuda")
    assert attach_kernel.launches == before + 1
    want = attach_arrivals(key, want_ends, first=first, count=count,
                           fill=fill, m=m, warm=warm, block=block,
                           backend="torch")
    assert attach_kernel.launches == before + 1
    return got, got_ends, want, want_ends


@pytest.mark.parametrize("mode", list(ATTACH_MODES))
@pytest.mark.parametrize("m", [1, 2, 3, 9])
def test_attach_kernel_matches_plain(cuda_device, m, mode):
    """600 arrivals after 300 in one launch — exact, one frozen block, or
    a warm-up and frozen blocks: the targets and the whole multiset equal
    the plain version's (m = 9: each candidate checked against up to
    eight kept targets)."""
    ends, fill, first = _grown_ends(m, 300, cuda_device)
    got, got_ends, want, want_ends = _attach_both(
        prng.key(4, device=cuda_device), ends, first, 600, fill, m, mode)
    assert torch.equal(got, want)
    assert torch.equal(got_ends, want_ends)


@pytest.mark.parametrize("mode", ["exact", "chunked"])
@pytest.mark.parametrize("m,count", [(1, 5000), (2, 5000), (9, 2000)])
def test_attach_kernel_right_after_the_seed(cuda_device, m, count, mode):
    """Arrivals straight after the seed clique: at m = 1 consecutive
    arrivals of one warp draw each other's targets (deep chains inside a
    warp), at m = 9 the first arrivals reject most draws (ten nodes for
    nine distinct targets)."""
    ends, fill, first = _grown_ends(m, 0, cuda_device, room=count)
    got, got_ends, want, want_ends = _attach_both(
        prng.key(6, device=cuda_device), ends, first, count, fill, m, mode)
    assert torch.equal(got, want)
    assert torch.equal(got_ends, want_ends)


@pytest.mark.parametrize("count", [1, 31, 127, 129, 1000])
def test_attach_kernel_ragged_counts(cuda_device, count):
    """Counts that are not a multiple of the kernel's 128 threads a
    block."""
    ends, fill, first = _grown_ends(2, 50, cuda_device, room=count)
    got, got_ends, want, want_ends = _attach_both(
        prng.key(8, device=cuda_device), ends, first, count, fill, 2)
    assert torch.equal(got, want)
    assert torch.equal(got_ends, want_ends)


def test_attach_kernel_repeated_launches_agree(cuda_device):
    """The same launch 20 times on fresh copies, each bit for bit the
    plain version's: a race between a target's store and its waiter's
    poll would show as a run that differs."""
    m, count = 1, 20000
    ends, fill, first = _grown_ends(m, 0, cuda_device, room=count)
    key = prng.key(9, device=cuda_device)
    _, _, want, want_ends = _attach_both(key, ends, first, count, fill, m)
    for _ in range(20):
        got_ends = ends.clone()
        got = attach_arrivals(key, got_ends, first=first, count=count,
                              fill=fill, m=m, backend="cuda")
        assert torch.equal(got, want)
        assert torch.equal(got_ends, want_ends)


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("n,chunk", [(30, None), (2000, None), (2000, 16),
                                     (2000, 64), (20000, 1024)])
def test_barabasi_albert_on_card_equals_cpu(cuda_device, n, m, chunk):
    """A build, exact or chunked (the last block with phantom arrivals),
    is one launch."""
    key = prng.key(5, device=cuda_device)
    before = attach_kernel.launches
    card = barabasi_albert(n, m, key, chunk=chunk)
    assert attach_kernel.launches == before + 1
    cpu = barabasi_albert(n, m, key.cpu(), chunk=chunk, device="cpu")
    assert torch.equal(card.neighbors.cpu(), cpu.neighbors)
    assert torch.equal(card.degrees.cpu(), cpu.degrees)


@pytest.mark.parametrize("n,p", [(50, 0.1), (12, 0.99), (20000, 2e-4)])
def test_erdos_renyi_on_card_equals_cpu(cuda_device, n, p):
    card = erdos_renyi(n, p, prng.key(3, device=cuda_device))
    cpu = erdos_renyi(n, p, prng.key(3, device="cpu"), device="cpu")
    assert torch.equal(card.neighbors.cpu(), cpu.neighbors)
    assert torch.equal(card.degrees.cpu(), cpu.degrees)


def test_attach_kernel_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.attach.attach import attach_cuda

    key = prng.key(0, device=cuda_device)
    ends = torch.zeros(20, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="slots"):
        attach_cuda(key, ends, first=3, count=4, fill=6, m=2)  # 22 > 20
    with pytest.raises(TypeError):
        attach_cuda(key, ends.long(), first=3, count=1, fill=6, m=2)
    with pytest.raises(ValueError):
        attach_cuda(key.cpu(), ends, first=3, count=1, fill=6, m=2)
    for warm, block in ((-1, None), (2, None), (0, 0)):
        with pytest.raises(ValueError, match="warm"):
            attach_cuda(key, ends, first=3, count=1, fill=6, m=2,
                        warm=warm, block=block)


# -------------------------------------------------------------- training
TRAIN_ARCHS = ["smollm-360m", "rwkv6-3b"]
TRAIN_HP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
#: as tests/test_torch_train.py: params at 2 % of the peak lr (Adam's
#: normalized step carries a tiny gradient's relative rounding into the
#: parameter at the scale of lr), the rest within float32 rounding
TRAIN_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_PARAMS_TOL = dict(rtol=1e-5, atol=2e-5)


def _train_batches(vocab, device, n=3):
    from repro_torch.train.data import DataConfig, SyntheticLMStream
    from repro_torch.train.loop import batch_to_device

    stream = SyntheticLMStream(DataConfig(vocab=vocab, seq_len=32,
                                          global_batch=4))
    return [batch_to_device(stream.batch_at(s), torch.device(device))
            for s in range(n)]


def _kernel_launches():
    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.kernels.wkv6 import wkv6 as wkv6_kernel

    return flash_kernel.launches, wkv6_kernel.launches


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("impl", ["ref", "chunked"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_on_card_equal_cpu(cuda_device, no_tf32, arch, impl,
                                       n_micro):
    """Reduced config, float32: three train steps on the card equal the
    same steps on the CPU from the same parameters (drawn on the CPU), and
    launch no hand-written kernel (the training path has none)."""
    import numpy as np

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.step import (
        TrainHParams,
        init_train_state,
        make_train_step,
    )

    cfg = get_config(arch).reduced().replace(attn_impl=impl)
    hp = TrainHParams(**TRAIN_HP, microbatches=n_micro)
    cpu_model = build_model(cfg, "cpu")
    cpu = init_train_state(cpu_model, 0, device="cpu")
    card_model = build_model(cfg, cuda_device)
    card = bridge.train_state_from_numpy(card_model,
                                         bridge.train_state_to_numpy(cpu))
    before = _kernel_launches()
    runs = {}
    for name, model, state in (("card", card_model, card),
                               ("cpu", cpu_model, cpu)):
        step_fn = make_train_step(model, hp)
        runs[name] = []
        for batch in _train_batches(cfg.vocab, model.device):
            state, metrics = step_fn(state, batch)
            runs[name].append((bridge.train_state_to_numpy(state),
                               {k: float(v) for k, v in metrics.items()}))
    assert _kernel_launches() == before
    for (got, got_m), (want, want_m) in zip(runs["card"], runs["cpu"]):
        assert got_m == pytest.approx(want_m, rel=1e-5, abs=1e-6)
        assert int(got["step"]) == int(want["step"])
        assert int(got["opt"]["count"]) == int(want["opt"]["count"])
        for part, tol in (("params", TRAIN_PARAMS_TOL),
                          ("mu", TRAIN_TOL), ("nu", TRAIN_TOL)):
            a = got[part] if part == "params" else got["opt"][part]
            b = want[part] if part == "params" else want["opt"][part]
            for (pa, xa), (pb, xb) in zip(_walk(a), _walk(b)):
                assert pa == pb
                np.testing.assert_allclose(xa, xb, err_msg=f"{part} {pa}",
                                           **tol)


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_card_makes_no_host_sync(cuda_device, arch, n_micro):
    """After a first step, a train step (bf16 weights, remat on) runs
    under ``set_sync_debug_mode("error")``: no host sync."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.step import (
        TrainHParams,
        init_train_state,
        make_train_step,
    )

    cfg = get_config(arch).reduced().replace(attn_impl="chunked",
                                             param_dtype="bfloat16")
    model = build_model(cfg, cuda_device)
    state = init_train_state(model, 0, device=cuda_device)
    step_fn = make_train_step(model, TrainHParams(**TRAIN_HP,
                                                  microbatches=n_micro))
    batches = _train_batches(cfg.vocab, cuda_device)
    state, _ = step_fn(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in batches[1:]:
            state, metrics = step_fn(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(metrics["loss"]).item()
    assert int(state.step) == 3


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_pallas_training_raises_on_card(cuda_device, arch):
    """Training through the kernels raises before launching one; without
    grad the same model runs them."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.step import (
        TrainHParams,
        init_train_state,
        make_train_step,
    )

    cfg = get_config(arch).reduced().replace(attn_impl="pallas")
    model = build_model(cfg, cuda_device)
    state = init_train_state(model, 0, device=cuda_device)
    batch = _train_batches(cfg.vocab, cuda_device, n=1)[0]
    before = _kernel_launches()
    with pytest.raises(RuntimeError, match="has no backward"):
        make_train_step(model, TrainHParams(**TRAIN_HP))(state, batch)
    assert _kernel_launches() == before
    with torch.no_grad():
        loss, _ = model.loss(state.params, batch)
    assert torch.isfinite(loss).item()
    after = _kernel_launches()
    grew = [a - b for a, b in zip(after, before)]
    assert grew == ([cfg.n_layers, 0] if arch == "smollm-360m"
                    else [0, cfg.n_layers])


# ------------------------------------------ the hybrid, MoE, enc-dec, VLM
FAMILY_ARCHS = ["hymba-1.5b", "qwen3-moe-235b-a22b", "arctic-480b",
                "seamless-m4t-medium", "internvl2-76b"]


def _family_batch(cfg, b, t, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, t), generator=gen,
                                     dtype=torch.int32)}
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = torch.randn((b, 8, cfg.d_model),
                                            generator=gen) * 0.1
    if cfg.is_encdec:
        batch["src_embeds"] = torch.randn((b, 20, cfg.d_model),
                                          generator=gen) * 0.1
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_families_on_card_equal_cpu(cuda_device, no_tf32, arch):
    """Reduced configs, float32, through "pallas" (flash in every
    attention layer on the card, the plain version on the CPU): the
    teacher-forced logits and aux, the loss, a prefill of 11 tokens and
    three decode steps — the second committing row 0 only — on the card
    equal the CPU's from the same parameters, within atol 1e-4 / rtol 1e-4
    (two layers of float32 sums in another order); the states after them
    (KV, SSM, enc_out) within 1e-5; flash launched once per attention
    layer and forward."""
    import numpy as np

    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced().replace(attn_impl="pallas")
    cpu_model, card_model = build_model(cfg, "cpu"), build_model(
        cfg, cuda_device)
    cpu_params = cpu_model.init(0, device="cpu")
    card_params = card_model.empty_params()
    card_params.load_state_dict(cpu_params.state_dict())
    layers = cfg.n_layers + cfg.enc_layers
    out = {}
    for name, model, params in (("cpu", cpu_model, cpu_params),
                                ("card", card_model, card_params)):
        batch = _family_batch(cfg, 2, 12, model.device)
        n0 = flash_kernel.launches
        with torch.no_grad():
            lt, aux = model.apply_train(params, batch)
            loss, _ = model.loss(params, {**batch,
                                          "labels": batch["tokens"]})
        pre = {**batch, "tokens": batch["tokens"][:, :11]}
        st = model.init_states(2, 32)
        lp, st = model.prefill(params, pre, st)
        logits = [lt, lp]
        tok = batch["tokens"][:, 11:]
        for commit in (None, torch.tensor([True, False]), None):
            ld, st = model.decode_step(
                params, tok, st,
                commit=None if commit is None else commit.to(model.device))
            logits.append(ld)
            tok = ld.argmax(-1, keepdim=True).to(torch.int32)
        if name == "card":
            assert flash_kernel.launches - n0 == 3 * layers
        out[name] = ([x.cpu() for x in logits],
                     {k: float(v) for k, v in aux.items()}, float(loss),
                     bridge.lm_states_to_numpy(st))
    (cl, caux, closs, cst), (gl, gaux, gloss, gst) = out["cpu"], out["card"]
    for a, b in zip(gl, cl):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert gaux == pytest.approx(caux, rel=1e-5, abs=1e-6)
    assert gloss == pytest.approx(closs, rel=1e-5)
    for (pa, xa), (pb, xb) in zip(_walk(gst), _walk(cst)):
        assert pa == pb
        np.testing.assert_allclose(xa, xb, atol=1e-5, rtol=1e-5,
                                   err_msg=pa)


def test_hymba_engine_on_card_matches_sequential_through_flash(
        cuda_device, no_tf32):
    """Reduced hymba (window 64, 8 meta tokens) on the card: prompts of
    5-90 tokens, some past the window, in chunks of 16; the engine's
    tokens (its masked decode waves, the SSM state written only for the
    wave's rows) equal sequential decoding whose one-shot prefill runs
    through the flash kernel; the levels kernel once per iteration."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import flash as flash_kernel
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("hymba-1.5b").reduced().replace(n_layers=3,
                                                     global_layers=(2,))
    model = build_model(cfg, cuda_device)
    params = model.init(0, device=cuda_device)
    seq = build_model(cfg.replace(attn_impl="pallas"), cuda_device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype("int32")
               for n in (5, 90, 70, 3)]
    n0 = flash_kernel.launches
    refs = []
    for p in prompts:
        st = seq.init_states(1, 128)
        lg, st = seq.prefill(params, {"tokens": torch.tensor(
            p, device=cuda_device)[None]}, st)
        toks = [int(lg[0].argmax())]
        for _ in range(5):
            lg, st = seq.decode_step(params, torch.tensor(
                [[toks[-1]]], dtype=torch.int32, device=cuda_device), st)
            toks.append(int(lg[0].argmax()))
        refs.append(toks)
    assert flash_kernel.launches - n0 == cfg.n_layers * len(prompts)
    levels_kernel.launches = 0
    eng = ServingEngine(model, params, n_slots=3, max_len=128,
                        prefill_chunk=16, device=cuda_device)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert [r.out_tokens for r in done] == refs
    assert levels_kernel.launches == eng.iterations



# ------------------------------------------------------------ cost telemetry
@pytest.mark.parametrize("family", ["axelrod", "sirs"])
def test_compiled_costs_on_card_count_the_wave_kernels(cuda_device, family):
    """``compiled_costs`` of ``wavefront`` on the card: the wave kernel's
    reported launches and its counter equal the window's waves, its work
    the waves × ``work()`` on the same inputs; the caller's state is
    unchanged; the temp bytes are the allocator's."""
    from repro_torch.engine import make_engine
    from repro_torch.kernels.axelrod.ops import work as axelrod_work
    from repro_torch.kernels.sir.ops import work as sir_work

    if family == "axelrod":
        model = AxelrodModel(AxelrodConfig(n_agents=20_000, n_features=37,
                                           q=3, omega=0.95),
                             device=cuda_device)
        kernel, name = axelrod_kernel, "axelrod_wave"
    else:
        model = SIRModel(SIRConfig(n_agents=40_000, k=14, subset_size=100),
                         device=cuda_device)
        kernel, name = sir_kernel, "sir_wave"
    eng = make_engine("wavefront", model, window=512, device=cuda_device)
    st0 = model.init_state(prng.key(1, device=cuda_device),
                           device=cuda_device)
    before = {k: v.clone() for k, v in st0.items()}
    key = prng.key(5, device=cuda_device)
    _, _, levels = eng._schedule(key, 0, 512)
    waves = int(levels.max()) + 1
    if family == "axelrod":
        one = axelrod_work(512, 37)
    else:
        rec = model.create_tasks(key, 0, 512)
        one = sir_work(rec["subset"], n_agents=40_000, k=14, subset_size=100)
    n0 = kernel.launches
    (cost,) = eng.compiled_costs(st0, seed=5).values()
    assert kernel.launches - n0 == waves
    assert cost.kernels == {name: {"launches": waves,
                                   "bytes": waves * one[0],
                                   "ops": waves * one[1]}}
    for k, v in st0.items():
        assert torch.equal(v, before[k]), k
    assert cost.device_peak_bytes is not None and cost.temp_bytes >= 0


@pytest.mark.parametrize("ename", ["sharded", "sharded_window_halo",
                                   "sharded_replicated"])
def test_world_one_cross_check_on_card(cuda_device, ename):
    """The reference's cross-check identity on the card (a world of one,
    no process group): exact on each barrier rung."""
    from repro_torch.engine import make_engine
    from repro_torch.obs.costs import ledger_cross_check

    topo = watts_strogatz(3000, 6, 0.1, prng.key(4, device=cuda_device),
                          device=cuda_device)
    model = SISModel(topo)
    eng = make_engine(ename, model, window=128, device=cuda_device)
    st0 = model.init_state(prng.key(1, device=cuda_device),
                           device=cuda_device)
    _, stats = eng.run(st0, 1024, seed=2)
    iters = eng.comm_iteration_counts(stats)
    chk = ledger_cross_check(eng.compiled_costs(st0, seed=2), iters,
                             stats["comm_bytes_total"])
    assert chk.ok and chk.ratio == 1.0 and chk.parsed_bytes > 0


def test_kernel_wrappers_report_their_work_on_card(cuda_device):
    """Each other kernel's wrapper on the card reports one launch and its
    ``work()`` on the same inputs to an installed recorder."""
    from repro_torch.kernels.attach.ops import work as attach_work
    from repro_torch.kernels.attach import ref as attach_ref
    from repro_torch.kernels.conflict.ops import work as conflict_work
    from repro_torch.kernels.flash.ops import flash_attention
    from repro_torch.kernels.flash.ops import work as flash_work
    from repro_torch.kernels.levels.ops import work as levels_work
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ops import work as wkv6_work
    from repro_torch.obs.costs import recording

    reads, writes, valid = _footprint(3, 256, 5, 1, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, 4, 64, 32, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    kv = torch.randn(2, 2, 64, 32, generator=g, device=cuda_device,
                     dtype=torch.bfloat16)
    r = torch.randn(1, 2, 40, 16, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    key = prng.key(3, device=cuda_device)
    ends = torch.zeros(4 + 2 * 2 * 300, dtype=torch.int32,
                       device=cuda_device)
    ends[:4] = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    r0 = attach_ref.rounds_drawn
    with recording() as rec:
        conf = conflict_matrix(reads, writes, valid)
        cross = conflict_block(reads, writes, reads, writes, valid, valid)
        wave_levels(conf, valid)
        flash_attention(q, kv, kv, causal=True)
        wkv6(r, r, r, torch.rand(r.shape, generator=g, device=cuda_device,
                                 dtype=torch.bfloat16),
             torch.zeros(2, 16, device=cuda_device))
        attach_arrivals(key, ends, first=2, count=300, fill=4, m=2)
    want = {
        "conflict_matrix": conflict_work([(reads, writes, valid)], conf),
        "conflict_block": conflict_work([(reads, writes, valid)] * 2,
                                        cross),
        "wave_levels": levels_work(256),
        "flash_attention": flash_work(2, 4, 2, 64, 64, 32),
        "wkv6": wkv6_work(1, 2, 40, 16, False),
        "attach": attach_work(300, 2, attach_ref.rounds_drawn - r0),
    }
    assert rec.kernels == {k: {"launches": 1, "bytes": b, "ops": o}
                           for k, (b, o) in want.items()}
