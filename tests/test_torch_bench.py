"""The port's headline entry point (bench_torch.py) on the CPU at a tiny
size: the record's shape, the metric names of its variants, and the failure
path (no card here, so ``main`` must print the ``value: -1`` record and
return non-zero)."""

import json

import pytest
import torch

import bench_torch

torch.set_num_threads(1)

KEYS = {"metric", "value", "unit", "selected", "budget", "fill"}


@pytest.mark.parametrize("variant, suffix", [
    (dict(), ""), (dict(dedup=True, refit_every=4), "_dedup_refit4"),
    (dict(sharded=True), "_sharded"), (dict(graph=False), "_eager")])
def test_run_returns_the_record(variant, suffix):
    rec = bench_torch.run(n=4000, selections=3, device="cpu", opt_itrs=20, **variant)
    assert set(rec) == KEYS and rec["unit"] == "s"
    assert rec["metric"] == f"bcores_build_n4000_m3_logreg_torch_cpu_seconds{suffix}"
    assert rec["value"] > 0 and rec["budget"] == 3
    assert 2 <= rec["selected"] <= 3 and rec["fill"] == round(rec["selected"] / 3, 3)
    if variant.get("dedup"):
        assert rec["selected"] == 3
    json.dumps(rec)


def test_full_data_select_runs():
    rec = bench_torch.run(n=3000, selections=2, device="cpu", opt_itrs=10, full_data=True)
    assert rec["metric"] == "bcores_build_n3000_m2_logreg_fullselect_torch_cpu_seconds"
    assert rec["selected"] == 2


@pytest.mark.parametrize("flags, name", [
    ([], "bcores_build_n1m_m100_logreg_torch_cuda_seconds"),
    (["--full-data"], "bcores_build_n1m_m100_logreg_fullselect_torch_cuda_seconds"),
    (["--dedup"], "bcores_build_n1m_m100_logreg_torch_cuda_seconds_dedup"),
    (["--refit-every", "4"], "bcores_build_n1m_m100_logreg_torch_cuda_seconds_refit4"),
    (["--sharded"], "bcores_build_n1m_m100_logreg_torch_cuda_seconds_sharded"),
    (["--eager", "--selections", "5", "--n", "2000"],
     "bcores_build_n2000_m5_logreg_torch_cuda_seconds_eager")])
def test_main_without_a_card_prints_the_failure_record(capsys, flags, name):
    assert not torch.cuda.is_available()
    assert bench_torch.main(flags) != 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(last)
    assert rec["metric"] == name and rec["value"] == -1.0 and rec["unit"] == "s"
    assert "CUDA" in rec["error"] and "vs_baseline" not in rec


def test_graph_on_the_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        bench_torch.run(n=2000, selections=1, device="cpu", opt_itrs=5, graph=True)
