"""The plain references against the port at the smoke configurations,
the reference's gossip in blocks against the whole, the configurations'
FLOP counts against hand counts, and the imports of every file under
``perfbench``."""
import ast
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from perfbench import manifest, weights
from perfbench.tests.smoke import SMOKE

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {"dense_decoder": "internlm2-1.8b-d10"}


def _config(family: str) -> dict:
    conf = json.loads((ROOT / "perfbench" / "configs" / f"{CONFIGS[family]}.json").read_text())
    return dict(conf, **SMOKE[family])


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_reference_loss_and_gradients_match_the_port_in_fp32(family):
    from perfbench.drivers.matcha_train import _nest, program_config
    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten

    c = _config(family)
    ref = manifest.load_module(ROOT / "perfbench" / "reference" / f"{family}.py")
    cfg = dataclasses.replace(program_config(c), compute_dtype="float32")
    model = Model(cfg)
    flat = weights.make(ref.param_specs(c), 2**31 + 3, "cpu")
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(s) for k, (s, _) in flatten(model.param_shapes()).items()}
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, c["vocab_size"], (2, 64), generator=gen, dtype=torch.int32)
    labels = torch.randint(0, c["vocab_size"], (2, 64), generator=gen, dtype=torch.int32)

    ours = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss_ref = ref.loss(ours, tokens, labels, c)
    g_ref = torch.autograd.grad(loss_ref, list(ours.values()))
    theirs = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss_port, _ = model.loss(_nest(theirs), {"tokens": tokens, "labels": labels})
    g_port = torch.autograd.grad(loss_port, list(theirs.values()))

    assert float(loss_ref.detach()) == pytest.approx(float(loss_port.detach()), rel=1e-5)
    for k, a, b in zip(ours, g_ref, g_port):
        scale = float(b.norm()) + 1e-12
        assert float((a - b).norm()) / scale < 1e-4, k


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_fp8_control_differs_from_fp32(family):
    c = _config(family)
    ref = manifest.load_module(ROOT / "perfbench" / "reference" / f"{family}.py")
    flat = weights.make(ref.param_specs(c), 5, "cpu")
    tokens = torch.randint(0, c["vocab_size"], (1, 32), generator=torch.Generator().manual_seed(2))
    a = float(ref.loss(flat, tokens, tokens, c, "fp32"))
    b = float(ref.loss(flat, tokens, tokens, c, "fp8"))
    assert a != b and abs(a - b) < 0.1 * a


def test_reference_gossip_in_blocks_is_the_whole_gossip(monkeypatch):
    from perfbench.frozen import planner
    from perfbench.reference import decen

    c = _config("dense_decoder")
    fam = manifest.load_module(ROOT / "perfbench" / "reference" / "dense_decoder.py")
    plan = planner.plan("paper8", 8, 0.5)
    replica = weights.make(fam.param_specs(c), 2**31 + 9, "cpu")
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, c["vocab_size"], (2, 8, 1, 16), generator=gen)
    labels = torch.randint(0, c["vocab_size"], (2, 8, 1, 16), generator=gen)

    def run():
        return decen.readings(fam, c, replica, tokens, labels, plan.permutations, plan.alpha,
                              plan.schedule(2, 0), lr=0.05, momentum=0.9, steps=2)

    whole = run()
    monkeypatch.setattr(decen, "GOSSIP_BLOCK", 1000)
    assert run() == whole
    # the gossip moved every leaf: a node's change differs from its neighbour's
    assert whole["change"]["embed.table"][0] != whole["change"]["embed.table"][1]


def test_flop_counts_against_hand_counts():
    dense = manifest.load_module(ROOT / "perfbench" / "reference" / "dense_decoder.py")
    conf = json.loads((ROOT / "perfbench" / "configs" / "internlm2-1.8b-d10.json").read_text())
    # internlm2-d10: 10 x (wq 2048^2 + wk, wv 2048 x 1024 + wo 2048^2 + 3 x 2048 x 8192)
    # + the head 2048 x 92544 = 818.68 M matmul parameters; attention at S 4096
    per_token = dense.flops_per_token(conf, 4096)
    matmul = 10 * (2 * 2048 * 2048 + 2 * 2048 * 1024 + 3 * 2048 * 8192) + 2048 * 92544
    assert matmul == 818_675_712
    assert per_token == 6 * matmul + 3 * 10 * 4 * 128 * 16 * 4097 / 2
    assert per_token * 8 * 4096 == pytest.approx(177.46e12, rel=1e-4)


def _roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_and_the_reference_imports_no_program():
    files = sorted((ROOT / "perfbench").rglob("*.py"))
    assert len(files) > 20
    bad = [f"{p}: {r}" for p in files for r in _roots(p) if r in ("jax", "jaxlib", "flax", "repro")]
    assert not bad
    ref = [f"{p}: {r}" for p in sorted((ROOT / "perfbench" / "reference").glob("*.py"))
           for r in _roots(p) if r in ("jax", "repro", "repro_torch")]
    assert not ref
