"""What the benchmark loads, and that its files are where its entries say.

Run in fresh interpreters: the harness, its drivers and readers, and the
port modules the drivers call load neither JAX nor the JAX package; the
reference loads nothing of the program either.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).parents[1]
ROOT = PB.parent

HARNESS = """
import sys, importlib, importlib.util, pathlib
sys.path.insert(0, {root!r})
sys.path.insert(0, {pb!r})
import run
from portbench import harness, calibrate, checks, flops, roofline, trace, traffic
from portbench.drivers import open_loop_batcher, fixed_batch, resident_train
for path in pathlib.Path({pb!r}, "metrics").glob("*.py"):
    spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from texocr_tpu_torch.serving.wrapper import TexOCR
from texocr_tpu_torch.serving.batcher import ServingBatcher
from texocr_tpu_torch.training import device_data, optimizers, train_step
from texocr_tpu_torch.data.dataset import ImageDataset
from texocr_tpu_torch.ops import flash_attention
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path.insert(0, {root!r})
from portbench.reference import model, train
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), pb=str(PB))],
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))


def test_harness_loads_no_jax():
    names = loaded(HARNESS)
    assert "texocr_tpu_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "texocr_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE)
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "texocr_tpu", "texocr_tpu_torch"}


def test_run_without_a_card_exits_without_a_result():
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", "base.serve",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files_and_metrics(cell):
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert (ROOT / configs[cell["config"]]["file"]).is_file()
    assert configs[cell["config"]]["file"] == f"portbench/configs/{cell['config']}.json"
    mix = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (PB / "drivers" / f"{mix['driver']}.py").is_file()
    limits = json.loads((PB / "limits" / f"{cell['name']}.json").read_text())
    assert all("limit" in v for v in limits.values())
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell["name"] in m["workloads"]]
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
