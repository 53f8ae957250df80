"""Ranks of the port's multi-process tests, and the launcher that runs them.

``run_world(case, world)`` starts ``world`` processes of this file, each
``python tests/torch_dist_worker.py CASE RANK WORLD STORE``, which join
one gloo world through a file store, run ``CASE`` and print one JSON
line (rank 0's is returned). The launcher has its own timeout: a rank
that hangs in a collective fails the one test, and every rank is killed.

Cases (tiny internlm2, 4 nodes on ``ring``, fp32, 3 steps from seed 0):

* ``s2``  world (1, 2): the sharded step (monolithic and streamed,
  sequential, overlap with its flush, faulted with all-ones gates)
  against the replicated single-process step each rank also runs;
* ``r2``  world (2, 1): the replicated step with the nodes over two
  data ranks (masked, static, overlap) against the single-process step;
* ``w22`` world (2, 2): the streamed sharded step, sequential.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES, BATCH, SEQ, STEPS = 4, 4, 32, 3


def run_world(case: str, world: int, *, timeout: float = 120.0) -> dict:
    """Run ``case`` on ``world`` ranks; rank 0's JSON result. Raises on a
    non-zero exit or when ``timeout`` seconds pass (every rank killed)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r), str(world), store],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
            for r in range(world)]
        deadline = time.monotonic() + timeout
        outs = []
        try:
            for p in procs:
                left = max(deadline - time.monotonic(), 0.1)
                outs.append(p.communicate(timeout=left))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            raise AssertionError(f"{case}: {world} ranks did not finish in {timeout} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, (out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"{case} rank {r} exited {p.returncode}:\n{err[-4000:]}")
        return json.loads(outs[0][0].strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
def _setup():
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    model = Model(cfg)
    opt = sgd(0.05, momentum=0.9)
    plan = plan_matcha(named_graph("ring", NODES, seed=3), 0.5, seed=0)
    sched = plan.schedule(STEPS, seed=0)
    data = DecentralizedBatches(cfg, NODES, BATCH, SEQ, seed=0, device="cpu")
    batches = [next(data) for _ in range(STEPS)]
    rows = [sched.activations[k].astype(np.float32) for k in range(STEPS)]
    return model, opt, plan, sched, batches, rows


def _run(step, params, opt_state, batches, bits, gstate=None):
    losses = []
    for k, b in enumerate(batches):
        if gstate is not None:
            params, opt_state, gstate, loss, _ = step(params, opt_state, gstate, b, bits[k])
        else:
            params, opt_state, loss, _ = step(params, opt_state, b, bits[k])
        losses.append(loss)
    return params, opt_state, gstate, losses


def _replicated(model, opt, plan, batches, bits, mode, spec=None, active=()):
    """The replicated step's params, losses and consensus (this rank's
    nodes with ``spec``)."""
    import torch

    from repro_torch.dist import decen_train as dt

    params = dt.init_stacked_params(model, NODES, seed=0, device="cpu")
    opt_state = dt.init_stacked_opt_state(opt, model, NODES, device="cpu")
    if spec is not None:
        params, opt_state = spec.local(params), spec.local(opt_state)
    step = dt.make_train_step(model, opt, plan, gossip_mode=mode, active=active, spec=spec)
    gstate = None
    if mode == "overlap":
        gstate = dt.init_gossip_state(plan, step.bplan, device="cpu", spec=spec)
    params, opt_state, gstate, losses = _run(step, params, opt_state, batches, bits, gstate)
    if gstate is not None:
        params = dt.make_gossip_flush(plan, step.bplan)(params, gstate)
    return params, torch.stack(losses), float(dt.consensus_distance(params, spec))


def _max_err(a, b) -> float:
    from repro_torch.tree import flatten

    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    return max(float((fa[k].float() - fb[k].float()).abs().max()) for k in fa)


def _sharded(model, opt, plan, spec, layout, batches, bits, mode, faulted=False):
    import torch

    from repro_torch.dist import fsdp

    shards = fsdp.init_fsdp_params(model, layout, spec, seed=0, device="cpu")
    opt_state = fsdp.init_fsdp_opt_state(opt, layout, spec, device="cpu")
    step = fsdp.make_fsdp_train_step(model, opt, plan, spec, layout, gossip_mode=mode,
                                     faulted=faulted)
    gstate = fsdp.init_fsdp_gossip_state(layout, spec, device="cpu") if mode == "overlap" \
        else None
    shards, opt_state, gstate, losses = _run(step, shards, opt_state, batches, bits, gstate)
    if gstate is not None:
        shards = fsdp.make_fsdp_gossip_flush(plan, layout)(shards, gstate)
    cons = float(fsdp.consensus_distance_sharded(shards, spec))
    return fsdp.gather_params(layout, shards, spec), torch.stack(losses), cons, step


def case_s2(spec, setup):
    import numpy as np

    from repro_torch.dist import fsdp

    model, opt, plan, sched, batches, rows = setup
    out = {}
    ones = [np.ones((NODES, plan.num_matchings), np.float32) * r for r in rows]
    for mode in ("masked", "overlap"):
        ref_p, ref_l, ref_c = _replicated(model, opt, plan, batches, rows, mode)
        layouts = {"mono": fsdp.make_layout(model, spec),
                   "stream": fsdp.make_stream_layout(model, spec)}
        for name, layout in layouts.items():
            runs = {"": (rows, False)}
            if mode == "masked" and name == "stream":
                runs["faulted"] = (ones, True)
            for tag, (bits, faulted) in runs.items():
                p, losses, cons, step = _sharded(model, opt, plan, spec, layout, batches,
                                                 bits, "sequential" if mode == "masked"
                                                 else mode, faulted)
                key = "_".join(x for x in (mode, name, tag) if x)
                out[key] = {"params": _max_err(p, ref_p),
                            "loss": float((losses - ref_l).abs().max()),
                            "consensus": abs(cons - ref_c),
                            "buckets": layout.plan.num_buckets}
    return out


def case_r2(spec, setup):
    model, opt, plan, sched, batches, rows = setup
    from repro_torch.tree import tree_map

    out = {}
    for mode, active in (("masked", ()), ("static", tuple(sched.active_indices(0))),
                         ("overlap", ())):
        ref_p, ref_l, ref_c = _replicated(model, opt, plan, batches, rows, mode, active=active)
        p, losses, cons = _replicated(model, opt, plan, batches, rows, mode, spec=spec,
                                      active=active)
        mine = tree_map(lambda a: a[spec.node_lo:spec.node_hi], ref_p)
        out[mode] = {"params": _max_err(p, mine),
                     "loss": float((losses - ref_l[:, spec.node_lo:spec.node_hi]).abs().max()),
                     "consensus": abs(cons - ref_c)}
    return out


def case_w22(spec, setup):
    from repro_torch.dist import fsdp

    model, opt, plan, sched, batches, rows = setup
    ref_p, ref_l, ref_c = _replicated(model, opt, plan, batches, rows, "masked")
    p, losses, cons, _ = _sharded(model, opt, plan, spec, fsdp.make_stream_layout(model, spec),
                                  batches, rows, "sequential")
    return {"params": _max_err(p, ref_p),
            "loss": float((losses - ref_l[:, spec.node_lo:spec.node_hi]).abs().max()),
            "consensus": abs(cons - ref_c)}


CASES = {"s2": (case_s2, 2), "r2": (case_r2, 1), "w22": (case_w22, 2)}


def main(argv) -> None:
    case, rank, world, store = argv[0], int(argv[1]), int(argv[2]), argv[3]
    import torch
    import torch.distributed as dist

    torch.manual_seed(0)
    from repro_torch.dist import decen_train as dt
    from repro_torch.launch.mesh import init_world, make_mesh

    fn, shard = CASES[case]
    init_world("cpu", rank=rank, world_size=world, init_method=f"file://{store}")
    try:
        spec = dt.make_spec(make_mesh(shard=shard, device="cpu"), NODES)
        result = fn(spec, _setup())
        print(json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
