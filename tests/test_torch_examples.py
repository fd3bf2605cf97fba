"""The port's examples (``repro_torch.examples``) and kernel benchmark
(``repro_torch.bench.kernels``) run on the CPU through their
``main(argv)`` at small sizes, and each one's own identity holds:
vertical == horizontal gradients, spill == recompute and lookahead on ==
off bitwise, plan-vs-actual reconciliation exact and the autotuner's
retune, the data-parallel engine == one rank bitwise, the offloaded
server's tokens == the in-memory loop's, the offload demo's traffic ==
its closed forms, and the LP search's choice == the reference example's
on the same machine preset."""
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree
from repro_torch.bench import kernels as bench_kernels
from repro_torch.configs import get_config
from repro_torch.examples import (lp_config_search, offload_ssd_demo,
                                  quickstart, serve_batched, train_dp,
                                  train_gpt100m)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes gain nothing from torch's intra-op threads, and under
    the parallel test workers every process's thread team contends for
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_gpt100m_makes_progress_and_round_trips(monkeypatch, tmp_path,
                                                      capsys):
    """The example at gpt-tiny (the test swaps the model; GPT-100M is a
    card's size), 80 steps of 8 x 64 tokens: the loss falls by more than
    1.0 (the example's own check), and the checkpoint it writes restores
    to its parameters bitwise."""
    monkeypatch.setattr(train_gpt100m, "get_config",
                        lambda name: get_config("gpt-tiny"))
    out = train_gpt100m.main(["--steps", "80", "--batch", "8", "--seq", "64",
                              "--ckpt-dir", str(tmp_path), "--device",
                              "cpu"])
    assert out["losses"][-1] < out["losses"][0] - 1.0
    assert out["restored_equal"] and out["step"] == 80
    assert sorted(os.listdir(tmp_path)) == ["meta.json", "params.npz"]
    assert capsys.readouterr().out.rstrip().endswith("OK")


@pytest.mark.parametrize("schedule", ["vertical", "horizontal"])
def test_offload_demo_traffic_is_its_closed_forms(schedule):
    """2 steps on the port's engine: the parameter loads and f32 gradient
    swaps per step equal §3.4's closed forms exactly, and the losses are
    finite."""
    out = offload_ssd_demo.main(["--schedule", schedule, "--steps", "2",
                                 "--seq", "32", "--device", "cpu"])
    assert out["param_load"] == out["closed_param_load"] > 0
    assert out["grad_swap"] == out["closed_grad_swap"] > 0
    assert out["traffic"]["param:cpu->gpu"] == 2 * out["closed_param_load"]
    assert all(np.isfinite(out["losses"]))


def test_train_dp_verifies_single_rank_bitwise():
    """``--verify-single-rank``: 2 simulated ranks and the single-rank
    engine give the same losses bit for bit, and each rank's bytes
    carry the all-gather and reduce-scatter routes."""
    out = train_dp.main(["--steps", "2", "--seq", "32",
                         "--verify-single-rank", "--device", "cpu"])
    assert out["match"] and out["losses"] == out["single_rank_losses"]
    assert len(out["traffic"]) == 2
    for snap in out["traffic"]:
        assert snap.get("param:net->gpu", 0) > 0
        assert snap.get("grad:gpu->net", 0) > 0


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}",
        os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("machine", ["a100-cloud", "a5000"])
def test_lp_config_search_chooses_the_reference_examples_config(
        machine, monkeypatch, capsys):
    """The port's example and the reference's ``examples/
    lp_config_search.py`` on the same model and machine preset print the
    same throughput landscape and choose the same (n, α, x)."""
    argv = ["--machine", machine]
    out = lp_config_search.main(argv)
    ported = capsys.readouterr().out
    ref = _reference_example("lp_config_search")
    monkeypatch.setattr(sys, "argv", ["lp_config_search.py"] + argv)
    ref.main()
    want = capsys.readouterr().out
    assert ported == want
    res = out["result"]
    assert f"n*={res.n} alpha*={res.alpha:.2f}" in want


def test_serve_batched_check_is_token_exact():
    """``--check``: 3 requests through the offloaded ``ServeEngine`` (with
    a mid-run preempt) give every greedy token of the in-memory B=1
    loop."""
    out = serve_batched.main(["--batch", "3", "--prompt-len", "6", "--gen",
                              "5", "--check", "--device", "cpu"])
    assert out["offloaded"] and out["tokens"] == out["reference_tokens"]
    assert [len(t) for t in out["tokens"]] == [5, 5, 5]


def test_serve_batched_in_memory_ssm():
    """``--no-offload`` serves the SSM family's smoke model through the
    in-memory loop (the offloaded engine is dense-only)."""
    out = serve_batched.main(["--arch", "falcon-mamba-7b", "--smoke",
                              "--batch", "2", "--prompt-len", "4", "--gen",
                              "3", "--device", "cpu"])
    assert not out["offloaded"] and [len(t) for t in out["tokens"]] == [3, 3]


def test_quickstart_identities(tmp_path):
    """Sections 1-7 with ``--wave 2 --activation-policy spill --trace
    --autotune``: vertical and horizontal gradients agree within
    tests/test_schedules.py's atol and one bf16 rounding (the vertical
    gradients are bf16 leaves), both Trainers' losses fall, spill ==
    recompute bitwise, lookahead depth 2 == 0 bitwise (losses and every
    byte counter), reconciliation exact, and the drifted autotuner
    retunes to depth 2."""
    trace = str(tmp_path / "trace.json")
    out = quickstart.main(["--wave", "2", "--activation-policy", "spill",
                           "--trace", trace, "--autotune", "--device",
                           "cpu"])
    gv, gh = out["equivalence"]["grads"]
    for a, b in zip(tree.leaves(gv), tree.leaves(gh)):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=3e-4,
                                   rtol=2 ** -8)
    for losses in out["trainer"].values():
        assert losses[-1] < losses[0]
    assert out["policy"]["spill"] == out["policy"]["recompute"]
    assert out["policy"]["resolved"] == "spill"
    assert out["policy"]["act_bytes"] > 0
    (l0, b0), (l2, b2) = out["lookahead"][0], out["lookahead"][2]
    assert l0 == l2 and b0 == b2
    assert sorted(out["wave"]) == [1, 2, 4]
    assert out["reconcile_ok"] and os.path.getsize(trace) > 0
    assert out["autotune"]["retunes"] >= 1
    assert out["autotune"]["depth"] == 2


def test_kernel_benchmark_plain_versions_on_the_cpu(capsys):
    """On the CPU the benchmark runs no kernel: every plain version within
    its tolerance of dense math, every row saying the kernel did not
    run, and no kernel time."""
    rows = bench_kernels.main(["--device", "cpu"])
    assert len(rows) == 6 and all(r["ok"] for r in rows.values())
    assert all(r["ms"] is None for r in rows.values())
    printed = capsys.readouterr().out
    assert printed.count("kernel not run on the CPU") == 6


@pytest.mark.parametrize("main", [
    train_gpt100m.main, offload_ssd_demo.main, train_dp.main,
    serve_batched.main, quickstart.main, bench_kernels.main],
    ids=["train_gpt100m", "offload_ssd_demo", "train_dp", "serve_batched",
         "quickstart", "bench_kernels"])
def test_entry_points_default_to_the_card(main):
    """Without ``--device`` each entry point asks for the card, and
    without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])
