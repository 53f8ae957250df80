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
import types

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


# ---------------------------------------------------------------------------
# The pod axis, sequence parallel, kv-seq-sharded serving, the inventory
# ---------------------------------------------------------------------------
POD_NODES = 8
SP_CASES = ("internlm2", "dbrx4", "mamba2", "jamba4")
KV_CASES = ("internlm2", "gemma3_4", "jamba4")
KV_DECODES = 3


def _inventory_matches(real, meta) -> dict:
    """One rank's real records against its meta view's, op for op (kind,
    axes, dtype, bytes, count) and exchange for exchange (the pairs)."""
    from repro_torch.analysis.collectives import inventory

    pairs = lambda rs: [r.perm for r in rs if r.kind == "ppermute"]  # noqa: E731
    return {"equal": inventory(real) == inventory(meta) and pairs(real) == pairs(meta),
            "count": len(real), "kinds": sorted({r.kind for r in real})}


def _step_views(model, opt, plan, spec_of, batches, bits, mode, rank, real_spec,
                active=()):
    """One replicated step of ``mode`` as this rank: its records on the
    real world and on its meta view of the same mesh (``spec_of(mesh)``)."""
    from repro_torch.analysis.collectives import collect
    from repro_torch.dist import decen_train as dt
    from repro_torch.launch.mesh import virtual_mesh

    out = {}
    for where, spec, dev in (("real", real_spec, "cpu"),
                             ("meta", spec_of(virtual_mesh(
                                 pod=real_spec.mesh.pod, data=real_spec.mesh.data,
                                 shard=real_spec.mesh.shard, model=real_spec.mesh.model,
                                 rank=rank)), "meta")):
        params = dt.init_stacked_params(model, spec.local_nodes, device=dev)
        state = dt.init_stacked_opt_state(opt, model, spec.local_nodes, device=dev)
        step = dt.make_train_step(model, opt, plan, gossip_mode=mode, active=active,
                                  spec=spec)
        b = {k: v.to(dev) for k, v in batches[0].items()}
        args = (params, state, b, bits[0])
        if mode == "overlap":
            args = (params, state, dt.init_gossip_state(plan, step.bplan, device=dev,
                                                        spec=spec), b, bits[0])
        out[where] = collect(step, *args, c10d=where == "real")
    return out["real"], out["meta"]


def case_pod4(spec, setup, data):
    """(pod 2, data 2): 8 nodes, 2 a rank, masked / static / overlap for 3
    steps against the single-process step, and each step's collectives
    against the rank's meta view; then (data 2, shard 2): the FSDP step in
    its three layouts, the collectives against the meta view."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.analysis.collectives import collect
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist import fsdp
    from repro_torch.launch.mesh import make_mesh, virtual_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    model, opt = Model(cfg), sgd(0.05, momentum=0.9)
    plan = plan_matcha(named_graph("paper8", POD_NODES, seed=3), 0.5, seed=0)
    sched = plan.schedule(STEPS, seed=0)
    it = DecentralizedBatches(cfg, POD_NODES, 2, 16, seed=0, device="cpu")
    batches = [next(it) for _ in range(STEPS)]
    bits = [sched.activations[k].astype(np.float32) for k in range(STEPS)]
    mesh = spec.mesh
    pspec = dt.make_spec(mesh, POD_NODES, multi_pod=True)
    rank = mesh.rank
    out = {"node_axes": list(pspec.node_axes), "nodes": [pspec.node_lo, pspec.node_hi],
           "pod_rank": mesh.pod_rank, "data_rank": mesh.data_rank}
    for mode in ("masked", "static", "overlap"):
        active = tuple(sched.active_indices(0)) if mode == "static" else ()

        def run(spec_):
            params = dt.init_stacked_params(model, POD_NODES, device="cpu")
            state = dt.init_stacked_opt_state(opt, model, POD_NODES, device="cpu")
            if spec_ is not None:
                params, state = spec_.local(params), spec_.local(state)
            step = dt.make_train_step(model, opt, plan, gossip_mode=mode, active=active,
                                      spec=spec_)
            g = dt.init_gossip_state(plan, step.bplan, device="cpu", spec=spec_) \
                if mode == "overlap" else None
            params, state, g, losses = _run(step, params, state, batches, bits, g)
            if g is not None:
                params = dt.make_gossip_flush(plan, step.bplan)(params, g)
            return params, torch.stack(losses)

        ref_p, ref_l = run(None)
        p, losses = run(pspec)
        mine = tree_map(lambda a: a[pspec.node_lo:pspec.node_hi], ref_p)
        real, meta = _step_views(model, opt, plan,
                                 lambda m: dt.make_spec(m, POD_NODES, multi_pod=True),
                                 batches, bits, mode, rank, pspec, active)
        out[mode] = {"params": _max_err(p, mine),
                     "loss": float((losses - ref_l[:, pspec.node_lo:pspec.node_hi])
                                   .abs().max()),
                     "inventory": _inventory_matches(real, meta),
                     "axes": sorted({tuple(r.axes) for r in real if r.kind == "ppermute"})}
    # FSDP on (data 2, shard 2): 4 nodes, 2 a data rank
    fmesh = make_mesh(shard=2, device="cpu")
    fspec = dt.make_spec(fmesh, NODES)
    plan4 = _plan()
    it4 = DecentralizedBatches(cfg, NODES, BATCH, SEQ, seed=0, device="cpu")
    b4 = next(it4)
    row = plan4.schedule(1, seed=0).activations[0].astype(np.float32)
    for lname, make in (("monolithic", lambda sp: fsdp.make_layout(model, sp)),
                        ("streamed", lambda sp: fsdp.make_stream_layout(model, sp,
                                                                        scan_aware=False)),
                        ("scan_streamed", lambda sp: fsdp.make_stream_layout(model, sp))):
        recs = {}
        for where, sp, dev in (("real", fspec, "cpu"),
                               ("meta", dt.make_spec(virtual_mesh(data=2, shard=2, rank=rank),
                                                     NODES), "meta")):
            lay = make(sp)
            shards = fsdp.init_fsdp_params(model, lay, sp, device=dev)
            st = fsdp.init_fsdp_opt_state(opt, lay, sp, device=dev)
            step = fsdp.make_fsdp_train_step(model, opt, plan4, sp, lay,
                                             gossip_mode="sequential")
            recs[where] = collect(step, shards, st, {k: v.to(dev) for k, v in b4.items()},
                                  row, c10d=where == "real")
        out[f"fsdp_{lname}"] = _inventory_matches(recs["real"], recs["meta"])
    return out


def _sp_serve(model, rules, rank, params_np, toks, prompt):
    """A prefill of ``prompt`` tokens and ``KV_DECODES`` decode steps on
    this rank's slices under ``rules``: the logits and this rank's caches
    after each."""
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
    logits, snaps = [], []
    lp, caches = prefill(p, toks[:, :prompt], caches)
    logits.append(lp)
    snaps.append(tree_map(lambda a: a.clone(), {str(i): c for i, c in enumerate(caches)}))
    for i in range(KV_DECODES):
        ld, caches = decode(p, toks[:, prompt + i:prompt + i + 1], caches, prompt + i)
        logits.append(ld)
    snaps.append(tree_map(lambda a: a.clone(), {str(i): c for i, c in enumerate(caches)}))
    return torch.cat(logits, 1), [[s[str(i)] for i in range(len(caches))] for s in snaps]


def case_sp2(spec, setup, data):
    """T 2: per SP case the sequence-parallel loss and gradient slices
    (written) and 3 masked steps against one process; per KV case a
    kv-seq-sharded prefill and decode steps (written); the collectives of
    an SP loss and gradient and of a kv-seq decode step against the rank's
    meta view."""
    import torch

    from repro_torch.analysis.collectives import collect
    from repro_torch.convert import params_from_numpy, shard_params
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist import serve as sv
    from repro_torch.dist.sharding import serve_rules, train_rules, use_rules
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten, tree_map

    mesh, rank = spec.mesh, spec.mesh.model_rank
    out = {"steps": {}}
    for case in SP_CASES:
        cfg = tp_config(case)
        model = Model(cfg)
        params_np, batch, _, _ = _tp_inputs(data, case)
        rules = train_rules(mesh, cfg, sequence_parallel=True)
        loss, grads = _tp_loss_grads(model, rules, rank, params_np, batch, {})
        _save(os.path.join(data, f"sp.{case}.r{rank}.npz"), loss={"loss": loss}, grads=grads)
        cspec = dt.make_spec(mesh, NODES, cfg=cfg, sequence_parallel=True)
        out["steps"][case] = _steps_against_one_process(cfg, cspec, batch=2, seq=16)["masked"]
    for case in KV_CASES:
        cfg = tp_config(case)
        model = Model(cfg)
        params_np, _, toks, _ = _tp_inputs(data, f"kv.{case}")
        rules = serve_rules(mesh, cfg, kv_seq_sharded=True)
        logits, (c_pre, c_dec) = _sp_serve(model, rules, rank, params_np, toks, TP_SERVE)
        _save(os.path.join(data, f"kv.{case}.r{rank}.npz"), logits={"all": logits},
              prefill=c_pre, decode=c_dec)
    # the inventories: an SP loss + gradients and a kv-seq decode step
    cfg = tp_config("internlm2")
    model = Model(cfg)
    params_np, batch, toks, _ = _tp_inputs(data, "internlm2")
    inv = {}
    for name in ("tp", "sp", "kvseq"):
        recs = {}
        for where, m, dev in (("real", mesh, "cpu"),
                              ("meta", virtual_mesh(model=2, rank=rank), "meta")):
            if name == "kvseq":
                rules = serve_rules(m, cfg, kv_seq_sharded=True)
            else:
                rules = train_rules(m, cfg, sequence_parallel=name == "sp")
            p = tree_map(lambda a: a.to(dev),
                         params_from_numpy(shard_params(params_np, model, rules, rank), "cpu"))
            if name == "kvseq":
                with use_rules(rules):
                    caches = model.init_cache(toks.shape[0], TP_MAX_LEN, device=dev)
                dec = sv.make_decode_step(model, rules, max_len=TP_MAX_LEN)
                t1 = toks[:, :1].to(dev)
                recs[where] = collect(lambda: dec(p, t1, caches, 5), c10d=where == "real")
            else:
                leaves = list(flatten(p).values())
                for leaf in leaves:
                    leaf.requires_grad_()
                b = {k: v.to(dev) for k, v in batch.items()}

                def run():
                    with use_rules(rules):
                        loss, _ = model.loss(p, b)
                        torch.autograd.grad(loss, leaves)

                recs[where] = collect(run, c10d=where == "real")
        inv[name] = _inventory_matches(recs["real"], recs["meta"])
    out["inventory"] = inv
    return out


# case -> (function, shard factor, model factor)
CASES = {"s2": (case_s2, 2, 1), "r2": (case_r2, 1, 1), "w22": (case_w22, 2, 1),
         "m2": (case_m2, 1, 2), "m4": (case_m4, 1, 4), "d2m2": (case_d2m2, 1, 2),
         "s2m2": (case_s2m2, 2, 2), "pod4": (case_pod4, 1, 1), "sp2": (case_sp2, 1, 2)}


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
        mesh = make_mesh(shard=shard, model=model, multi_pod=case == "pod4", device="cpu")
        if case == "pod4":
            result = fn(types.SimpleNamespace(mesh=mesh), None, data)
        elif model == 1:
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
