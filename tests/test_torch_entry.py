"""PyTorch port, the entry (lbmpc_tpu_torch/entry.py, the counterpart of
__graft_entry__.py) and the examples (lbmpc_tpu_torch/examples/): the
flagship solve, the four-stage dry run on 2 CPU shards with the
reference's gates, and both examples run with --cpu at tiny sizes in a
subprocess, their last line's JSON keys checked."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from lbmpc_tpu_torch.entry import dryrun_multichip, entry

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_entry_solves_the_flagship_batch():
    fn, (dx0,) = entry(device="cpu")
    z, conv = fn(dx0)
    assert dx0.shape == (8, 4) and z.shape == (8, 21) and conv.shape == (8,)
    assert bool(torch.isfinite(z).all()) and bool(conv.all())


def test_dryrun_multichip_on_two_cpu_shards(capsys):
    out = dryrun_multichip(2, devices=["cpu"] * 2)
    text = capsys.readouterr().out
    for stage in (1, 2, 3, 4):
        assert f"dryrun_multichip stage {stage} OK" in text
    assert "the shards repeat them" in text
    assert out["stage1"]["total"] == 4 and out["stage3"]["total"] == 4
    assert out["stage2"]["max_diff"] < 5e-3 and out["stage4"]["rel_diff"] < 1e-9


FLEET_KEYS = {"metric", "value", "instances", "steps", "chunk", "fused", "converged_frac",
              "devices", "hosts", "device"}
SWEEP_KEYS = {"metric", "value", "scenarios", "steps", "converged", "total",
              "settling_p50_s", "ctrl_error_p50", "final_dx1_max", "devices", "device"}


@pytest.mark.parametrize("name,args,keys", [
    ("fleet_100k", ["--instances", "16", "--chunk", "8", "--steps", "2"], FLEET_KEYS),
    ("fleet_100k", ["--instances", "16", "--steps", "2", "--fused", "--qp-kernel",
                    "pallas_full", "--warm-chain"], FLEET_KEYS),
    ("scenario_sweep", ["--scenarios", "8", "--steps", "2"], SWEEP_KEYS),
])
def test_example_runs_on_the_cpu(name, args, keys):
    out = subprocess.run([sys.executable, "-m", f"lbmpc_tpu_torch.examples.{name}", "--cpu",
                          *args], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) == keys and line["device"] == "cpu"
    if name == "fleet_100k":
        assert line["instances"] == 16 and line["converged_frac"] == 1.0
        assert line["chunk"] == (8 if "--chunk" in args else 16)   # budget-picked
    else:
        assert line["converged"] == line["total"] == 8
