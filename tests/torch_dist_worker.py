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

Tensor-parallel cases (``m``: the model axis), at the tiny presets, fp32;
the JAX package's inputs and results are made by the test process
(``tests/test_torch_tp.py``), which passes their directory:

* ``m2``   world (1, 1, 2): per model kind (``TP_CASES``) the loss and
  gradients, a prefill and one decode step from the JAX weights, each
  rank writing its slices for the test to join; and 3 masked steps
  against the port's single-process step;
* ``m4``   world (1, 1, 4): tiny internlm2 at T 4 (the ``kv_in``
  branch), loss and gradients;
* ``d2m2`` world (2, 1, 2): the nodes over two data ranks at T 2 in
  masked, static and overlap gossip against the single-process step,
  and serving with the batch split over the data ranks;
* ``s2m2`` world (1, 2, 2): the streamed FSDP step at S 2 x T 2,
  sequential, against the single-process step.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES, BATCH, SEQ, STEPS = 4, 4, 32, 3


def run_world(case: str, world: int, *, timeout: float = 120.0, data: str = "") -> dict:
    """Run ``case`` on ``world`` ranks; rank 0's JSON result. Raises on a
    non-zero exit or when ``timeout`` seconds pass (every rank killed).
    ``data``: a directory the case reads inputs from and writes to."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r), str(world), store, data],
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
@functools.lru_cache(maxsize=None)
def _plan():
    """The MATCHA plan of every case (4 nodes on ``ring``, budget 0.5):
    planned once a process."""
    from repro_torch.core import named_graph, plan_matcha

    return plan_matcha(named_graph("ring", NODES, seed=3), 0.5, seed=0)


def _setup():
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    model = Model(cfg)
    opt = sgd(0.05, momentum=0.9)
    plan = _plan()
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
    cons = float(fsdp.consensus_distance_sharded(shards, spec, layout))
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


# ---------------------------------------------------------------------------
# Tensor parallel
# ---------------------------------------------------------------------------
# case -> (arch, config overrides): one model of each kind, fp32
TP_CASES = {
    "internlm2": ("internlm2_1_8b", {}),
    "dbrx4": ("dbrx_132b", {}),
    "dbrx16": ("dbrx_132b", {"moe_num_experts": 16, "moe_top_k": 4}),
    "mamba2": ("mamba2_370m", {}),
    "jamba4": ("jamba_v0_1_52b", {"num_layers": 4}),
    "gemma3_4": ("gemma3_4b", {"num_layers": 4}),
    "whisper": ("whisper_base", {}),
    "internvl2": ("internvl2_1b", {}),
}
TP_B, TP_S, TP_SERVE, TP_MAX_LEN = 2, 32, 24, 48


def tp_config(case: str):
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config

    arch, over = TP_CASES[case]
    return dataclasses.replace(get_smoke_config(arch), compute_dtype="float32", **over)


def _unflat(flat: dict, prefix: str) -> dict:
    from repro_torch.models.module import _assign

    out: dict = {}
    for key, a in flat.items():
        if key.startswith(prefix):
            _assign(out, key[len(prefix):], a)
    return out


def _caches_unflat(flat: dict, prefix: str) -> list:
    """``{prefix}{segment}.{path}`` keys back to the per-segment list."""
    tree = _unflat(flat, prefix)
    return [tree[str(s)] for s in range(len(tree))]


def _save(out: str, **trees) -> None:
    """Trees (dicts or lists of dicts of tensors) to one npz, keys
    ``name/path``; bf16 widened to fp32."""
    import numpy as np

    from repro_torch.tree import flatten

    flat = {}
    for name, t in trees.items():
        if isinstance(t, list):
            t = {str(i): c for i, c in enumerate(t)}
        for path, a in flatten(t).items():
            a = a.detach().cpu()
            flat[f"{name}/{path}"] = (a.float() if a.dtype.is_floating_point else a).numpy()
    np.savez(out, **flat)


def _tp_inputs(data: str, case: str):
    """The JAX weights, the training batch, the serving tokens and the
    frontend stub of a case, as the test process wrote them."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import to_bfloat16

    with np.load(os.path.join(data, f"{case}.in.npz")) as z:
        flat = {k: z[k] for k in z.files}
    params = _unflat(flat, "p/")
    batch = {"tokens": torch.as_tensor(flat["b/tokens"]),
             "labels": torch.as_tensor(flat["b/labels"])}
    frontend = {}
    if "f/key" in flat:
        frontend[str(flat["f/key"])] = to_bfloat16(flat["f/draw"])
    return params, batch, torch.as_tensor(flat["s/tokens"]), frontend


def _tp_loss_grads(model, rules, rank, params_np, batch, frontend):
    """This rank's loss and gradient slices from the whole weights."""
    import torch

    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.dist.sharding import use_rules
    from repro_torch.tree import flatten, tree_map

    p = params_from_numpy(shard_params(params_np, model, rules, rank), "cpu")
    leaves = flatten(p)
    for leaf in leaves.values():
        leaf.requires_grad_()
    with use_rules(rules):
        loss, _ = model.loss(p, {**batch, **frontend})
        grads = iter(torch.autograd.grad(loss, list(leaves.values())))
    return loss.detach(), tree_map(lambda _: next(grads), p)


def _tp_serve(model, rules, rank, params_np, toks, frontend):
    """A prefill and one decode step on this rank's slices: the whole
    logits of each and this rank's caches after each."""
    import torch

    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.dist import serve as sv
    from repro_torch.dist.sharding import use_rules
    from repro_torch.tree import tree_map

    p = params_from_numpy(shard_params(params_np, model, rules, rank), "cpu")
    with use_rules(rules):
        caches = model.init_cache(toks.shape[0], TP_MAX_LEN, device="cpu")
    prefill = sv.make_prefill_step(model, rules, max_len=TP_MAX_LEN)
    decode = sv.make_decode_step(model, rules, max_len=TP_MAX_LEN)
    pre = {k: v for k, v in frontend.items()}
    lp, caches = prefill(p, toks[:, :TP_SERVE], caches, **pre)
    after_prefill = tree_map(lambda a: a.clone(), {str(i): c for i, c in enumerate(caches)})
    start = TP_SERVE + (frontend["prefix_embeddings"].shape[1]
                        if "prefix_embeddings" in frontend else 0)
    ld, caches = decode(p, toks[:, TP_SERVE:], caches, start)
    return lp, ld, [after_prefill[str(i)] for i in range(len(caches))], caches


def _steps_against_one_process(cfg, spec, *, modes=("masked",), batch=BATCH, seq=SEQ):
    """3 steps of the tensor-parallel run against the single-process
    step from the same weights: max params, loss and consensus gaps."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist.sharding import use_rules
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    model, opt = Model(cfg), sgd(0.05, momentum=0.9)
    plan = _plan()
    sched = plan.schedule(STEPS, seed=0)
    data = DecentralizedBatches(cfg, NODES, batch, seq, seed=0, device="cpu")
    batches = [next(data) for _ in range(STEPS)]
    bits = [sched.activations[k].astype(np.float32) for k in range(STEPS)]
    out = {}
    for mode in modes:
        active = tuple(sched.active_indices(0)) if mode == "static" else ()
        ref_p, ref_l, ref_c = _replicated(model, opt, plan, batches, bits, mode, active=active)
        with use_rules(spec.rules):
            p, losses, cons = _replicated(model, opt, plan, batches, bits, mode, spec=spec,
                                          active=active)
        whole = spec.gather_nodes(spec.gather_model(p))
        out[mode] = {"params": _max_err(whole, ref_p),
                     "loss": float((losses - ref_l[:, spec.node_lo:spec.node_hi])
                                   .abs().max()),
                     "consensus": abs(cons - ref_c)}
    return out


def case_m2(spec, setup, data):
    """Per model kind: loss, gradients and serving on this rank's slices
    (written for the test), then 3 masked steps against one process."""
    from repro_torch.dist.sharding import serve_rules, train_rules
    from repro_torch.models.transformer import Model

    rank = spec.mesh.model_rank
    out = {}
    for case in TP_CASES:
        cfg = tp_config(case)
        model = Model(cfg)
        params_np, batch, toks, frontend = _tp_inputs(data, case)
        rules = train_rules(spec.mesh, cfg)
        train_front = {k: v for k, v in frontend.items()}
        loss, grads = _tp_loss_grads(model, rules, rank, params_np, batch, train_front)
        lp, ld, c_pre, c_dec = _tp_serve(model, serve_rules(spec.mesh, cfg), rank, params_np,
                                         toks, frontend)
        _save(os.path.join(data, f"{case}.r{rank}.npz"), loss={"loss": loss}, grads=grads,
              logits={"prefill": lp, "decode": ld}, prefill=c_pre, decode=c_dec)
        from repro_torch.dist import decen_train as dt

        cspec = dt.make_spec(spec.mesh, NODES, cfg=cfg)
        out[case] = _steps_against_one_process(cfg, cspec, batch=2, seq=16)["masked"]
    return out


def case_m4(spec, setup, data):
    """Tiny internlm2 at T 4: loss and gradient slices, written."""
    from repro_torch.dist.sharding import train_rules
    from repro_torch.models.transformer import Model

    cfg = tp_config("internlm2")
    rules = train_rules(spec.mesh, cfg)
    params_np, batch, _, _ = _tp_inputs(data, "internlm2")
    loss, grads = _tp_loss_grads(Model(cfg), rules, spec.mesh.model_rank, params_np, batch, {})
    _save(os.path.join(data, f"m4.r{spec.mesh.model_rank}.npz"), loss={"loss": loss},
          grads=grads)
    return {"kv_in": rules.axis("kv_in"), "heads": rules.axis("heads")}


def case_d2m2(spec, setup, data):
    """Nodes over two data ranks at T 2 (masked, static, overlap) and
    serving with the batch split over the data ranks."""
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist.sharding import serve_rules
    from repro_torch.models.transformer import Model

    cfg = tp_config("internlm2")
    cspec = dt.make_spec(spec.mesh, NODES, cfg=cfg)
    out = _steps_against_one_process(cfg, cspec, modes=("masked", "static", "overlap"))
    params_np, _, toks, _ = _tp_inputs(data, "internlm2")
    per = toks.shape[0] // spec.mesh.data
    mine = toks[spec.mesh.data_rank * per:(spec.mesh.data_rank + 1) * per]
    lp, ld, _, c_dec = _tp_serve(Model(cfg), serve_rules(spec.mesh, cfg),
                                 spec.mesh.model_rank, params_np, mine, {})
    if spec.mesh.model_rank == 0:
        _save(os.path.join(data, f"d2m2.d{spec.mesh.data_rank}.npz"),
              logits={"prefill": lp, "decode": ld})
    return out


def case_s2m2(spec, setup, data):
    """The streamed FSDP step at S 2 x T 2, sequential, against one
    process."""
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist import fsdp
    from repro_torch.dist.sharding import use_rules

    model, opt, plan, sched, batches, rows = setup
    cspec = dt.make_spec(spec.mesh, NODES, cfg=model.cfg)
    ref_p, ref_l, ref_c = _replicated(model, opt, plan, batches, rows, "masked")
    layout = fsdp.make_stream_layout(model, cspec)
    with use_rules(cspec.rules):
        p, losses, cons, _ = _sharded(model, opt, plan, cspec, layout, batches, rows,
                                      "sequential")
    whole = cspec.gather_model(p)
    return {"params": _max_err(whole, ref_p),
            "loss": float((losses - ref_l[:, spec.node_lo:spec.node_hi]).abs().max()),
            "consensus": abs(cons - ref_c), "buckets": layout.plan.num_buckets}


# case -> (function, shard factor, model factor)
CASES = {"s2": (case_s2, 2, 1), "r2": (case_r2, 1, 1), "w22": (case_w22, 2, 1),
         "m2": (case_m2, 1, 2), "m4": (case_m4, 1, 4), "d2m2": (case_d2m2, 1, 2),
         "s2m2": (case_s2m2, 2, 2)}


def main(argv) -> None:
    case, rank, world, store = argv[0], int(argv[1]), int(argv[2]), argv[3]
    data = argv[4] if len(argv) > 4 else ""
    import torch
    import torch.distributed as dist

    torch.manual_seed(0)
    from repro_torch.dist import decen_train as dt
    from repro_torch.launch.mesh import init_world, make_mesh

    fn, shard, model = CASES[case]
    init_world("cpu", rank=rank, world_size=world, init_method=f"file://{store}")
    try:
        mesh = make_mesh(shard=shard, model=model, device="cpu")
        if model == 1:
            result = fn(dt.make_spec(mesh, NODES), _setup())
        else:
            setup = _setup()
            spec = dt.make_spec(mesh, NODES, cfg=setup[0].cfg)
            result = fn(spec, setup, data)
        print(json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
