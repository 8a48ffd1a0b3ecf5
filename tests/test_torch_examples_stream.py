"""The port's streaming drivers (betacores_tpu_torch/examples/streaming_build.py
and streaming_outofcore.py) against the JAX package's, on the CPU, each at
the arguments of its JAX test in tests/test_examples.py.

streaming_build's rows come from the port's generators, so only the
printed lines and the quality claim (the streamed coreset beats the prior's
held-out accuracy) are compared. streaming_outofcore's rows are numpy's
``default_rng(--seed)`` in both, so the exact full-data posterior and the
prior's reverse KL to it must agree (rtol 1e-5, float32), and its
``--mesh 2x1`` on a gloo world of two ranks must give the streamed build's
result."""

import json

import numpy as np
import pytest

from test_torch_examples import _run_jax, _run_port

SB = ["--N", "1500", "--chunk-size", "500", "--m-leaf", "4", "--m-final", "8", "--m-buf", "8",
      "--proj-dim", "12", "--opt-itrs", "10"]
OC = ["--n", "4000", "--d", "3", "--chunk", "1000", "--n-single", "2000", "--m-leaf", "4",
      "--m-final", "6", "--proj-dim", "12", "--opt-itrs", "10"]


def _acc(out):
    return (float(out.split("test acc ")[1].split(" ")[0]),
            float(out.split("(prior ")[1].split(")")[0]))


def test_streaming_build_prints_the_jax_drivers_line(capsys, monkeypatch):
    rec = _run_port("streaming_build", SB + ["--compare-single-shot"])
    port_out = capsys.readouterr().out
    _run_jax("streaming_build.py", SB, monkeypatch)
    jax_out = capsys.readouterr().out
    for out in (port_out, jax_out):
        assert "streamed coreset m=" in out
        acc, prior = _acc(out)
        assert np.isfinite(acc) and acc > prior
    assert (rec["acc"], rec["acc_prior"]) == pytest.approx(_acc(port_out), abs=1e-4)
    assert "; single-shot m=" in port_out and np.isfinite(rec["acc_single"])
    assert int(rec["state"].m) == 8 and rec["leaf_wts"].shape == (3 * 8,)
    assert [len(rec["timings"].sections[k]) for k in ("leaf", "final")] == [3, 1]


@pytest.fixture(scope="module")
def outofcore():
    """The port's streamed and 2x1-mesh runs and the JAX driver's, with the
    JAX exact posterior captured from its reverse-KL calls."""
    import runpy
    import sys
    from pathlib import Path

    import betacores_tpu.evaluation as jeval

    mp = pytest.MonkeyPatch()
    seen = []
    inner = jeval.reverse_forward_kl

    def spy(post, full):
        seen.append(full)
        return inner(post, full)

    try:
        import contextlib
        import io

        outs = {}
        for tag, run in (
                ("port", lambda: _run_port("streaming_outofcore", OC)),
                ("mesh", lambda: _run_port("streaming_outofcore",
                                           OC[:6] + ["--n-single", "0"] + OC[8:]
                                           + ["--mesh", "2x1"])),
                ("jax", None)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if run is not None:
                    rec = run()
                else:
                    mp.setattr(jeval, "reverse_forward_kl", spy)
                    mp.setattr(sys, "argv", ["streaming_outofcore.py"] + OC)
                    root = Path(__file__).resolve().parents[1]
                    runpy.run_path(str(root / "examples" / "streaming_outofcore.py"),
                                   run_name="__main__")
                    rec = None
            outs[tag] = (rec, buf.getvalue())
    finally:
        mp.undo()
    return outs, seen[0]


def test_streaming_outofcore_matches_the_jax_driver(outofcore):
    outs, jax_full = outofcore
    (rec, port_out), (_, jax_out) = outs["port"], outs["jax"]
    got, want = json.loads(port_out.strip().splitlines()[-1]), json.loads(
        jax_out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for k in ("n", "d", "chunk", "gib", "n_single"):
        assert got[k] == want[k]
    np.testing.assert_allclose(got["rkl_prior"], want["rkl_prior"], rtol=1e-5)
    np.testing.assert_allclose(rec["post_full"].mu.numpy(), np.asarray(jax_full.mu), rtol=1e-5)
    # the JAX test's claims
    assert got["nnz_stream"] >= 2
    assert np.isfinite(got["rkl_stream"]) and np.isfinite(got["rkl_single"])
    assert got["rkl_stream"] < got["rkl_prior"]
    for line in ("N=4,000 d=3 f32 = 0.0 GiB host data, chunks of 1,000",
                 "streamed build (4,000 rows, 4 leaves)", "single-shot at N=2,000"):
        assert line in port_out and line in jax_out


def test_streaming_outofcore_mesh_2x1_on_gloo_equals_the_stream(outofcore):
    outs, _ = outofcore
    (rec, _), (mesh, mesh_out) = outs["port"], outs["mesh"]
    assert "mesh-streamed leaf pass over {'data': 2, 'samp': 1} (4 leaves in rounds of 2; " \
           "gloo)" in mesh_out
    assert mesh["rkl_stream"] == rec["rkl_stream"] and mesh["nnz_stream"] == rec["nnz_stream"]
    assert "rkl_single" not in mesh


def test_streaming_outofcore_refuses_mesh_with_checkpoint_and_a_mesh_past_the_cards():
    with pytest.raises(SystemExit, match="incompatible"):
        _run_port("streaming_outofcore", OC + ["--mesh", "2x1", "--checkpoint", "x.npz"])
    from betacores_tpu_torch.examples import streaming_outofcore

    # the card asked for (no --device cpu) on a machine with fewer cards
    with pytest.raises(ValueError, match=r"needs 2 cards, this machine has \d"):
        streaming_outofcore.main(OC + ["--mesh", "2x1"])
