"""The case list of the sharded engines' four-rank tests, and the two
launches that run it: the port on four ``gloo`` ranks on the CPU
(``torch_rank``, started through ``torch.multiprocessing``) and the
reference on four virtual XLA devices (``jax_main``, subprocesses with
``--xla_force_host_platform_device_count=4``, each taking a share of the
list). Each process writes one pickle of {(case id, total): result} for
test_torch_sharded.py to hold against the other side. Each side imports
only its own package.

The cases are the reference's own (tests/test_engine_sharded.py): voter
and SIS over ring(102, 4), lattice2d(10, 10) and watts_strogatz(128, 4,
0.1) at totals of 128 and 150 with W = 64, through all four engines
(102 agents over 4 ranks: the padded shard path); Axelrod (n = 41) and
SIRS (n = 400, s = 25) through all four, and SIRS at n = 420, s = 30,
whose subsets straddle the row blocks (a task owned by two ranks); the
comm ladder (watts_strogatz(4096), W = 128); the degenerate width
(ring(48) and ring(100) at W = 32, where the monolithic halo or the pair
halo trips the width guard, and watts_strogatz(4096) at W = 32, where the
pair halo wins); a model without row contracts; one with only the write
contract; and the comm-regression configuration (W = 128 and 256).
Between them every rung of the ladder runs: split, halo, pair and full.

The three barrier runs of the comm ladder on voter (``COST_CASES``: the
split, window-halo and replicated rungs) also return each side's
executor costs after the run: the executed iteration counts
(``comm_iteration_counts``, read first) and the collectives of
``compiled_costs`` — recorded at the port's call sites, parsed from the
compiled HLO on the reference's side — by depth and resolved.
"""
import os
import pickle
import sys
import traceback

WORLD = 4
ENGINES = ("sharded", "sharded_window_halo", "sharded_replicated",
           "sharded_overlap")
RING = ("ring", 102, 4)
LATTICE = ("lattice2d", 10, 10)
WS128 = ("watts_strogatz", 128, 4, 0.1, 2)
WS4096 = ("watts_strogatz", 4096, 4, 0.1, 2)


def _case(cid, model, topo, engine, window, totals, *, seed=3,
          state_seed=7, **kwargs):
    return {"id": cid, "model": model, "topo": topo, "engine": engine,
            "window": window, "totals": totals, "seed": seed,
            "state_seed": state_seed, "kwargs": kwargs}


def _cases():
    out = []
    for model in ("voter", "sis"):
        for tname, topo in (("ring", RING), ("lattice", LATTICE),
                            ("ws128", WS128)):
            for e in ENGINES:
                out.append(_case(f"{model}-{tname}-{e}", model, topo, e,
                                 64, (128, 150)))
    for e in ENGINES:
        out.append(_case(f"axelrod-{e}", "axelrod", None, e, 64,
                         (100, 150), seed=1, state_seed=0))
        out.append(_case(f"sirs-{e}", "sirs", None, e, 64, (64, 150),
                         seed=1, state_seed=0))
    for e in ("sharded", "sharded_overlap"):
        out.append(_case(f"sirs_straddle-{e}", "sirs_straddle", None, e,
                         64, (64, 150), seed=1, state_seed=0))
    # the comm ladder over one schedule; its sharded runs double as the
    # comm-regression configuration at W = 128
    for model in ("voter", "sis"):
        for e in ("sharded", "sharded_window_halo", "sharded_replicated"):
            out.append(_case(f"ladder-{model}-{e}", model, WS4096, e, 128,
                             (256,)))
        out.append(_case(f"regression-{model}-w256", model, WS4096,
                         "sharded", 256, (512,)))
    # the degenerate width
    for e in ("sharded_window_halo", "sharded"):
        out.append(_case(f"degenerate-ring48-{e}", "voter", ("ring", 48, 4),
                         e, 32, (70,), seed=1, state_seed=0))
    out.append(_case("degenerate-ring100-sharded_window_halo", "voter",
                     ("ring", 100, 4), "sharded_window_halo", 32, (150,),
                     seed=1, state_seed=0))
    out.append(_case("degenerate-ring100-window_halo_overlap", "voter",
                     ("ring", 100, 4), "sharded_window_halo", 32, (150,),
                     seed=1, state_seed=0, overlap=True))
    out.append(_case("degenerate-ring100-sharded_overlap", "voter",
                     ("ring", 100, 4), "sharded_overlap", 32, (150,),
                     seed=1, state_seed=0))
    out.append(_case("degenerate-ws4096-window_halo_overlap", "voter",
                     WS4096, "sharded_window_halo", 32, (128,),
                     overlap=True))
    # models without (both) row contracts
    out.append(_case("no_contracts-sharded", "voter_no_contracts",
                     ("ring", 100, 4), "sharded", 64, (150,), seed=1,
                     state_seed=0))
    out.append(_case("write_only-sharded", "voter_write_only",
                     ("ring", 100, 4), "sharded", 32, (100,), seed=1,
                     state_seed=0))
    return out


CASES = _cases()

#: the ladder's barrier runs whose executor costs both sides return
COST_CASES = ("ladder-voter-sharded", "ladder-voter-sharded_window_halo",
              "ladder-voter-sharded_replicated")


def _costs(eng, st0, stats, seed):
    """The executed iteration counts, then each executor's collectives by
    depth and resolved against them (the counts come first: the costs
    re-prepare the state, which resets the ledger)."""
    iters = eng.comm_iteration_counts(stats)
    costs = eng.compiled_costs(st0, seed=seed)
    return {"iters": iters,
            "costs": {name: {"bytes_by_depth":
                             c.collectives.bytes_by_depth(),
                             "total": c.collectives.total_bytes(iters)}
                      for name, c in costs.items()}}


# ---------------------------------------------------------------- builders
def _cached(build):
    """``build(model, topo)`` memoized per process: cases that share a
    model and topology share one instance (and, on the reference's side,
    its compiled generators)."""
    memo = {}

    def get(model, topo):
        if (model, topo) not in memo:
            memo[model, topo] = build(model, topo)
        return memo[model, topo]
    return get


@_cached
def _jax_model(spec_model, topo_spec):
    import jax

    from repro import mabs as M
    from repro import topology as T

    topo = None
    if topo_spec is not None:
        kind, *args = topo_spec
        if kind == "ring":
            topo = T.ring(*args)
        elif kind == "lattice2d":
            topo = T.lattice2d(*args, neighborhood="von_neumann")
        else:
            n, k, p, seed = args
            topo = T.watts_strogatz(n, k, p, jax.random.key(seed))
    return _model(M, spec_model, topo)


@_cached
def _torch_model(spec_model, topo_spec):
    from repro_torch import mabs as M
    from repro_torch import topology as T
    from repro_torch.utils import prng

    topo = None
    if topo_spec is not None:
        kind, *args = topo_spec
        if kind == "ring":
            topo = T.ring(*args, device="cpu")
        elif kind == "lattice2d":
            topo = T.lattice2d(*args, neighborhood="von_neumann",
                               device="cpu")
        else:
            n, k, p, seed = args
            topo = T.watts_strogatz(n, k, p, prng.key(seed, device="cpu"),
                                    device="cpu")
    return _model(M, spec_model, topo, device="cpu")


def _model(M, name, topo, **dev):
    if name == "voter":
        return M.VoterModel(topo)
    if name == "sis":
        return M.SISModel(topo)
    if name == "axelrod":
        return M.AxelrodModel(M.AxelrodConfig(n_agents=41, n_features=3,
                                              q=3), **dev)
    if name == "sirs":
        return M.SIRModel(M.SIRConfig(n_agents=400, k=6, subset_size=25),
                          **dev)
    if name == "sirs_straddle":
        return M.SIRModel(M.SIRConfig(n_agents=420, k=6, subset_size=30),
                          **dev)

    class NoContracts(M.VoterModel):
        def task_read_agents(self, recipes):
            return None

        def task_write_agents(self, recipes):
            return None

    class WriteOnly(M.VoterModel):
        def task_read_agents(self, recipes):
            return None   # writes declared, reads not

    return {"voter_no_contracts": NoContracts,
            "voter_write_only": WriteOnly}[name](topo)


# ---------------------------------------------------------------- the port
def torch_rank(rank, store_path, out_dir):
    """One of WORLD gloo ranks: every case through the port's engine, on
    the default group; rank 0 also runs the port's oracle. Writes
    ``torch_rank<r>.pkl`` (or ``torch_rank<r>.err`` and exits 1)."""
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
            world_size=WORLD)
        try:
            results = _run_torch(rank)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"torch_rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(out_dir, f"torch_rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def _run_torch(rank):
    from repro_torch.core import ProtocolConfig, run_oracle
    from repro_torch.engine import make_engine
    from repro_torch.utils import prng

    results, oracles = {}, {}
    for case in CASES:
        model = _torch_model(case["model"], case["topo"])
        st0 = model.init_state(prng.key(case["state_seed"], device="cpu"),
                               device="cpu")
        eng = make_engine(case["engine"], model, window=case["window"],
                          device="cpu", **case["kwargs"])
        for total in case["totals"]:
            out, stats = eng.run(st0, total, seed=case["seed"])
            res = {"state": {k: v.numpy() for k, v in out.items()},
                   "stats": stats, "comm_bytes": eng.agents.comm_bytes,
                   "collectives": eng.agents.collectives,
                   "world_size": eng.agents.world_size}
            if case["id"] in COST_CASES:
                res.update(_costs(eng, st0, stats, case["seed"]))
            okey = (case["model"], case["topo"], case["window"], total,
                    case["seed"], case["state_seed"])
            if rank == 0:
                if okey not in oracles:
                    o = run_oracle(model, st0, total, seed=case["seed"],
                                   config=ProtocolConfig(
                                       window=case["window"]),
                                   device="cpu")
                    oracles[okey] = {k: v.numpy() for k, v in o.items()}
                res["oracle"] = oracles[okey]
            results[(case["id"], total)] = res
    return results


# ----------------------------------------------------------- the reference
def jax_main(out_path, part=0, parts=1):
    """Cases ``part::parts`` through the reference's engine on WORLD
    virtual devices (its compiles dominate, so the list is cut over
    several processes); writes the pickle to ``out_path``."""
    import jax
    import numpy as np

    from repro.engine import make_engine

    if jax.device_count() != WORLD:
        raise RuntimeError(f"{jax.device_count()} devices, not {WORLD}")
    results = {}
    for case in CASES[part::parts]:
        model = _jax_model(case["model"], case["topo"])
        st0 = model.init_state(jax.random.key(case["state_seed"]))
        eng = make_engine(case["engine"], model, window=case["window"],
                          **case["kwargs"])
        for total in case["totals"]:
            out, stats = eng.run(st0, total, seed=case["seed"])
            results[(case["id"], total)] = {
                "state": {k: np.asarray(v) for k, v in out.items()},
                "stats": stats}
            if case["id"] in COST_CASES:
                results[(case["id"], total)].update(
                    _costs(eng, st0, stats, case["seed"]))
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    jax_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
