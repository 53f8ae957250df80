"""The port's optimizers against the JAX package's, update for update.

Same numpy-drawn params and grads (fp32 and bf16 params) through both
packages' SGD and AdamW for three updates, each LR schedule at steps
around its edges, and ``make_optimizer`` from each package's
``TrainConfig``. Tolerance: 1e-6 relative (fp32 elementwise arithmetic;
XLA may contract a multiply-add into an FMA). A node-stacked AdamW state
round-trips through both packages' checkpoints bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt
from repro_torch.tree import flatten


def _trees(dtype_j, dtype_t, seed):
    rng = np.random.default_rng(seed)
    arrays = {"a": {"w": rng.standard_normal((7, 5))}, "b": rng.standard_normal((11,))}
    arrays = jax.tree.map(lambda a: a.astype(np.float32), arrays)
    j = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype_j), arrays)
    t = {"a": {"w": torch.from_numpy(arrays["a"]["w"]).to(dtype_t)},
         "b": torch.from_numpy(arrays["b"]).to(dtype_t)}
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum,nesterov,weight_decay", [
    (0.0, False, 0.0), (0.9, False, 0.0), (0.9, True, 1e-2),
])
def test_sgd_matches_jax(dtype, momentum, nesterov, weight_decay):
    dj, dt = getattr(jnp, dtype), getattr(torch, dtype)
    jp, tp = _trees(dj, dt, 0)
    jo = jopt.sgd(0.05, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
    to = topt.sgd(0.05, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
    js, ts = jo.init(jp), to.init(tp)
    for k in range(3):
        jg, tg = _trees(jnp.float32, torch.float32, k + 1)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    assert int(ts["step"]) == int(js["step"]) == 3
    want = flatten(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp))
    for path, t in flatten(tp).items():
        assert t.dtype == dt
        np.testing.assert_allclose(t.float().numpy(), want[path], rtol=1e-6, atol=1e-7)
    if momentum:
        jv = flatten(jax.tree.map(np.asarray, js["velocity"]))
        for path, v in flatten(ts["velocity"]).items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), jv[path], rtol=1e-6, atol=1e-7)


def test_clip_by_global_norm_matches_jax():
    jg, tg = _trees(jnp.float32, torch.float32, 3)
    assert float(topt.global_norm(tg)) == pytest.approx(float(jopt.global_norm(jg)), rel=1e-6)
    for max_norm in (0.5, 1e3):
        want = flatten(jax.tree.map(np.asarray, jopt.clip_by_global_norm(jg, max_norm)))
        for path, t in flatten(topt.clip_by_global_norm(tg, max_norm)).items():
            np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-6)


# ---------------------------------------------------------------------------
# AdamW, the LR schedules and make_optimizer (tolerance as above: 1e-6
# relative; the bias corrections' powers may differ by an fp32 ulp)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adamw_matches_jax(dtype, weight_decay):
    dj, dt = getattr(jnp, dtype), getattr(torch, dtype)
    jp, tp = _trees(dj, dt, 0)
    jo = jopt.adamw(0.01, weight_decay=weight_decay)
    to = topt.adamw(0.01, weight_decay=weight_decay)
    js, ts = jo.init(jp), to.init(tp)
    assert ts["step"].dtype == torch.int32
    for k in range(3):
        jg, tg = _trees(jnp.float32, torch.float32, k + 1)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == 3
    want = flatten(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp))
    for path, t in flatten(tp).items():
        assert t.dtype == dt
        np.testing.assert_allclose(t.float().numpy(), want[path], rtol=1e-6, atol=1e-7)
    for slot in ("mu", "nu"):
        jm = flatten(jax.tree.map(np.asarray, js[slot]))
        for path, v in flatten(ts[slot]).items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), jm[path], rtol=1e-6, atol=1e-12)


SCHEDULES = {
    "constant": (lambda m: m.constant_schedule(0.1)),
    "step": (lambda m: m.step_decay_schedule(0.1, [100, 150])),
    "step_factor": (lambda m: m.step_decay_schedule(0.3, [2, 5, 9], factor=0.5)),
    "cosine": (lambda m: m.cosine_schedule(0.1, 200, warmup_steps=20)),
    "cosine_no_warmup": (lambda m: m.cosine_schedule(0.1, 50, min_ratio=0.0)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    jf, tf = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    for step in (0, 1, 2, 5, 9, 19, 20, 21, 50, 99, 100, 149, 150, 199, 200, 300):
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jf(jnp.int32(step))), rtol=1e-6,
                                   err_msg=f"{name} at step {step}")


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("schedule", ["constant", "cosine", "step"])
def test_make_optimizer_matches_jax(optimizer, schedule):
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro_torch.configs.base import TrainConfig

    kw = dict(optimizer=optimizer, lr_schedule=schedule, steps=4, warmup_steps=1,
              learning_rate=0.05, weight_decay=1e-3)
    jo, to = jopt.make_optimizer(JaxTrainConfig(**kw)), topt.make_optimizer(TrainConfig(**kw))
    jp, tp = _trees(jnp.float32, torch.float32, 0)
    js, ts = jo.init(jp), to.init(tp)
    assert set(ts) == set(js)
    for k in range(4):
        jg, tg = _trees(jnp.float32, torch.float32, k + 1)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    want = flatten(jax.tree.map(np.asarray, jp))
    for path, t in flatten(tp).items():
        np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        topt.make_optimizer(TrainConfig(optimizer="lion"))
    with pytest.raises(ValueError):
        topt.make_optimizer(TrainConfig(lr_schedule="linear"))


@pytest.mark.parametrize("per_node_files", [False, True], ids=["stacked", "per_node"])
def test_stacked_adamw_state_roundtrips_through_both_checkpoints(tmp_path, per_node_files):
    """A node-stacked AdamW state (fp32 mu / nu, int32 step per node)
    written by the port restores bit-equal in the JAX package, and the
    reverse: the checkpoint code held to a second state tree."""
    from repro.checkpoint import ckpt as jckpt
    from repro.configs.registry import get_smoke_config as jax_smoke_config
    from repro.models.transformer import Model as JaxModel
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist import decen_train as dt
    from repro_torch.models.transformer import Model

    nodes = 3
    model = Model(get_smoke_config("internlm2_1_8b"))
    opt = topt.adamw(1e-3, weight_decay=0.1)
    state = dt.init_stacked_opt_state(opt, model, nodes, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for slot in ("mu", "nu"):
        for leaf in flatten(state[slot]).values():
            leaf.copy_(torch.rand(leaf.shape, generator=gen))
    state["step"].copy_(torch.tensor([4, 5, 6], dtype=torch.int32))
    params = dt.init_stacked_params(model, nodes, seed=0, device="cpu")

    ckpt.save_run(str(tmp_path / "port"), params, state, step=6, per_node_files=per_node_files)
    _, jstate, step = jckpt.restore_run(str(tmp_path / "port"))
    assert step == 6 and str(jstate["step"].dtype) == "int32"
    jflat = flatten(jax.tree.map(np.asarray, jstate))
    tflat = flatten(state)
    assert jflat.keys() == tflat.keys()
    for path, t in tflat.items():
        assert str(jflat[path].dtype) == str(t.dtype).removeprefix("torch."), path
        np.testing.assert_array_equal(jflat[path], t.numpy(), err_msg=path)

    # the reverse: the JAX package's own AdamW state, written by JAX
    jmodel = JaxModel(jax_smoke_config("internlm2_1_8b"))
    jo = jopt.adamw(1e-3, weight_decay=0.1)
    jp = jax.tree.map(lambda a: jnp.stack([a] * nodes), jmodel.init(jax.random.key(0)))
    js = jax.tree.map(lambda a: jnp.stack([a] * nodes), jo.init(jmodel.init(jax.random.key(0))))
    js = {"step": js["step"] + jnp.arange(nodes, dtype=jnp.int32),
          "mu": jax.tree.map(lambda a: a + 0.5, js["mu"]),
          "nu": jax.tree.map(lambda a: a + 0.25, js["nu"])}
    jckpt.save_run(str(tmp_path / "jax"), jp, js, step=2, per_node_files=per_node_files)
    _, back, step = ckpt.restore_run(str(tmp_path / "jax"), device="cpu")
    assert step == 2 and back["step"].dtype == torch.int32
    want = flatten(jax.tree.map(np.asarray, js))
    for path, t in flatten(back).items():
        assert str(t.dtype).removeprefix("torch.") == str(want[path].dtype), path
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)
