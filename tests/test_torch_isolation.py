"""The port stands alone: no JAX and nothing of ``repro`` in its package or
in ``chip_smoke.py``; its entry points run on the card unless the caller
asks for the CPU."""
import ast
from pathlib import Path
from unittest import mock

import pytest
import torch

from repro_torch.configs.base import FLConfig

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"fedeec.py", "engine.py", "distill_loss.py", "chip_smoke.py"} <= names


def _no_card():
    return mock.patch.object(torch.cuda, "is_available", return_value=False)


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    from repro_torch.core.fedeec import FedEEC
    from repro_torch.core.topology import Tree
    from repro_torch.fl.engine import build_problem, run_experiment

    cfg = FLConfig(num_clients=2, num_edges=1, samples_per_client=4, test_samples=8,
                   image_size=8, embed_dim=16)
    with _no_card():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_experiment("fedeec", cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_problem(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FedEEC(cfg, Tree.three_tier(1, 2), {}, {})


def test_unported_options_raise():
    from repro_torch.fl.engine import run_experiment

    cfg = FLConfig(num_clients=2, num_edges=1, samples_per_client=4, test_samples=8,
                   image_size=8, embed_dim=16)
    for kw in ({"scenario": "stable"}, {"faults": "lossy"}, {"checkpoint_every": 1},
               {"tracer": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_experiment("fedeec", cfg, device="cpu", **kw)


def test_registry_has_the_slice_algorithms():
    from repro_torch.fl.api import list_algorithms

    assert list_algorithms() == ["fedagg", "fedeec"]


def test_fedeec_runs_on_cpu_when_asked():
    from repro_torch.fl.engine import run_experiment

    # two edges of one client each; the migration demo moves client0 to
    # edge1 before the first round, leaving edge0 with an empty store
    cfg = FLConfig(num_clients=2, num_edges=2, samples_per_client=8, test_samples=16,
                   image_size=8, embed_dim=16, distill_steps=1)
    res = run_experiment("fedeec", cfg, rounds=2, device="cpu", migration_round=0)
    assert len(res.acc_curve) == 2 and all(0.0 <= a <= 1.0 for a in res.acc_curve)
    assert res.comm_bytes["end-edge"] > 0 and len(res.round_s) == 2
