"""``python -m rocket_tpu_torch.launch`` against ``rocket_tpu.launch``: N
workers with torch.distributed's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, where the
reference sets ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``), rank-prefixed output, a failure's stragglers torn
down (TERM, grace, KILL), a worker-initiated drain releasing its peers,
the rendezvous retry signature matched on torch's c10d messages, and
``--supervise`` restarting, draining and refusing a crash loop.

Every worker here is a few lines of standard-library Python, each
subprocess with its own timeout.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from rocket_tpu_torch import launch
from rocket_tpu_torch.launch import WorkerGroup
from rocket_tpu_torch.resilience.faults import EXIT_DRAINED

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("ROCKET_TPU_")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _launch(args, timeout=120):
    return subprocess.run([sys.executable, "-m", "rocket_tpu_torch.launch", *args], env=_env(),
                          cwd=str(ROOT), capture_output=True, text=True, timeout=timeout)


def test_two_workers_get_torch_distributed_environment(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(
        "import json, os, sys\n"
        "keys = ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK', 'LOCAL_RANK',\n"
        "        'JAX_COORDINATOR_ADDRESS', 'JAX_PROCESS_ID')\n"
        "sys.stdout.write('ENV ' + json.dumps({k: os.environ.get(k) for k in keys}) + '\\n')\n")
    out = _launch(["-n", "2", str(script)])
    assert out.returncode == 0, out.stdout + out.stderr
    seen = {}
    for line in out.stdout.splitlines():
        if line.startswith("[rank ") and " ENV " in line:
            rank = int(line[len("[rank "):line.index("]")])
            seen[rank] = json.loads(line.split(" ENV ", 1)[1])
    assert sorted(seen) == [0, 1]
    port = seen[0]["MASTER_PORT"]
    for rank, env in seen.items():
        assert env["MASTER_ADDR"] == "127.0.0.1" and env["MASTER_PORT"] == port
        assert env["WORLD_SIZE"] == "2" and env["RANK"] == env["LOCAL_RANK"] == str(rank)
        assert env["JAX_COORDINATOR_ADDRESS"] is None and env["JAX_PROCESS_ID"] is None
    assert port.isdigit() and int(port) > 0


def test_launch_propagates_failure(tmp_path):
    script = tmp_path / "bad.py"
    script.write_text("import sys; sys.exit(3)\n")
    assert _launch(["-n", "2", str(script)]).returncode != 0


def test_coordinator_error_signatures_on_torch_rendezvous_messages():
    """The port-race retry fires only on output carrying a rendezvous
    FAILURE of torch's TCPStore; benign progress lines and the user's own
    failures never match."""
    sig = launch._COORDINATOR_ERROR_RE
    failures = [
        "torch.distributed.DistNetworkError: The server socket has failed to listen on any "
        "local network address. port: 29500, useIpv6: 0, code: -98, name: EADDRINUSE, "
        "message: address already in use",
        "RuntimeError: The server socket has failed to bind to [::]:29500 (errno: 98 - Address "
        "already in use).",
        "[W socket.cpp:697] [c10d] The client socket has failed to connect to "
        "[localhost]:29500 (errno: 111 - Connection refused).",
        "[E socket.cpp:957] [c10d] The client socket has timed out after 300s while trying to "
        "connect to (127.0.0.1, 29500).",
        "torch.distributed.DistStoreError: Timed out after 901 seconds waiting for clients. "
        "1/2 clients joined.",
        "RuntimeError: connect() timed out. Original timeout was 1800000 ms.",
        "torch.distributed.DistNetworkError: Connection reset by peer",
        "RuntimeError: failed to connect to the store at 127.0.0.1:29500",
        "[c10d] TCPStore client failed: connection refused",
    ]
    for line in failures:
        assert sig.search(line), f"must match: {line!r}"
    benign = [
        "[I socket.cpp:452] [c10d] The server socket has started to listen on [::]:29500.",
        "[I ProcessGroupNCCL.cpp] [c10d] TORCH_NCCL_ASYNC_ERROR_HANDLING: 3",
        "Rendezvous complete for rank 0",
        "Added key: store_based_barrier_key:1 to store for rank: 0",
        "Initializing process group with MASTER_ADDR=127.0.0.1 MASTER_PORT=29500",
        "ImportError: No module named 'mymodel'",
        "AssertionError: expected 4 processes",
        "ValueError: bad learning rate",
        "loss=2.31 step=10",
    ]
    for line in benign:
        assert not sig.search(line), f"must NOT match: {line!r}"


def test_launch_tears_down_stragglers(tmp_path):
    script = tmp_path / "split.py"
    script.write_text("import os, sys, time\n"
                      "if os.environ['RANK'] == '1':\n"
                      "    sys.exit(5)\n"
                      "time.sleep(600)\n")
    t0 = time.time()
    assert _launch(["-n", "2", str(script)]).returncode != 0
    assert time.time() - t0 < 60


def test_launch_kills_a_sigterm_ignoring_straggler(tmp_path):
    script = tmp_path / "stubborn.py"
    script.write_text("import os, signal, sys, time\n"
                      "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
                      "if os.environ['RANK'] == '1':\n"
                      "    time.sleep(1)\n"
                      "    sys.exit(5)\n"
                      "time.sleep(600)\n")
    t0 = time.time()
    assert _launch(["-n", "2", "--term-grace", "2", str(script)]).returncode != 0
    assert time.time() - t0 < 60


def test_worker_initiated_drain_releases_blocked_peers(tmp_path):
    script = tmp_path / "split_drain.py"
    script.write_text("import os, signal, sys, time\n"
                      "if os.environ['RANK'] == '1':\n"
                      "    time.sleep(0.5)\n"
                      f"    sys.exit({EXIT_DRAINED})\n"
                      "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
                      "time.sleep(600)\n")
    group = WorkerGroup(2, str(script), term_grace_s=2.0, env=_env())
    group.spawn()
    t0 = time.time()
    rc, codes = group.wait(drain_grace_s=2.0)
    assert time.time() - t0 < 60
    assert codes[1] == EXIT_DRAINED and rc != 0
    assert set(group.output_tail()) == {"0", "1"}


def test_plain_launch_passes_drain_grace_to_wait(monkeypatch):
    import argparse

    seen = {}
    monkeypatch.setattr(WorkerGroup, "spawn", lambda self: None)

    def fake_wait(self, drain_event=None, drain_grace_s=60.0, on_poll=None):
        seen["drain_grace_s"] = drain_grace_s
        return 0, [0]

    monkeypatch.setattr(WorkerGroup, "wait", fake_wait)
    monkeypatch.setattr(WorkerGroup, "teardown", lambda self: None)
    args = argparse.Namespace(nproc=1, script="train.py", script_args=[], term_grace=10.0,
                              drain_grace=7.5)
    assert launch._run_once(args, port=45555) == (0, False)
    assert seen["drain_grace_s"] == 7.5


@pytest.mark.parametrize("flag,want", [("--max-restarts", "max_restarts"),
                                       ("--crash-loop", "crash_loop_threshold"),
                                       ("--min-procs", "min_procs"),
                                       ("--degrade-after", "degrade_after")])
def test_supervise_flags_map_onto_the_policy(monkeypatch, flag, want):
    import rocket_tpu_torch.resilience.supervisor as sup

    made = {}

    class Fake:
        def __init__(self, nproc, script, script_args, policy, **kw):
            made.update(policy=policy, **kw)

        def install_signal_handlers(self):
            made["signals"] = True

        def run(self):
            return 0

    monkeypatch.setattr(sup, "Supervisor", Fake)
    assert launch.main(["--supervise", "-n", "1", flag, "5", "--backoff", "0.1",
                        "--metrics-port", "0", "train.py"]) == 0
    assert getattr(made["policy"], want) == 5 and made["policy"].backoff_base_s == 0.1
    assert made["metrics_port"] == 0 and made["signals"]


def test_supervised_launch_restarts_until_success(tmp_path):
    script = tmp_path / "flaky.py"
    script.write_text("import os, sys\n"
                      "sys.exit(3 if os.environ['ROCKET_TPU_GENERATION'] == '0' else 0)\n")
    state_dir = tmp_path / "state"
    out = _launch(["--supervise", "-n", "1", "--backoff", "0.05", "--progress-grace", "0.01",
                   "--state-dir", str(state_dir), str(script)])
    assert out.returncode == 0, out.stdout + out.stderr
    state = json.loads((state_dir / "supervisor.json").read_text())
    assert state["outcome"] == "completed" and state["restarts"] == 1
    assert [g["outcome"] for g in state["generations"]] == ["crashed", "completed"]
    assert 0.0 <= state["goodput_fraction"] <= 1.0


def test_supervised_launch_honors_a_drained_worker(tmp_path):
    script = tmp_path / "drainer.py"
    script.write_text(f"import sys; sys.exit({EXIT_DRAINED})\n")
    state_dir = tmp_path / "state"
    out = _launch(["--supervise", "-n", "1", "--state-dir", str(state_dir), str(script)])
    assert out.returncode == 0, out.stdout + out.stderr
    state = json.loads((state_dir / "supervisor.json").read_text())
    assert state["outcome"] == "drained" and state["restarts"] == 0
    assert state["generations"][0]["exit_codes"] == [EXIT_DRAINED]


def test_supervised_launch_crash_loop_gives_up(tmp_path):
    script = tmp_path / "dead.py"
    script.write_text("import sys; print('boom-trail'); sys.exit(9)\n")
    state_dir = tmp_path / "state"
    out = _launch(["--supervise", "-n", "1", "--backoff", "0.05", "--crash-loop", "2",
                   "--progress-grace", "1e9", "--state-dir", str(state_dir), str(script)])
    assert out.returncode != 0
    state = json.loads((state_dir / "supervisor.json").read_text())
    assert state["outcome"] == "crash_loop" and len(state["generations"]) == 2
    assert any("boom-trail" in line for line in state["generations"][-1]["output_tail"]["0"])


def test_supervisor_sigterm_drains_a_worker_through_the_runtime(tmp_path):
    """SIGTERM to the supervisor is forwarded; a worker whose Runtime is
    supervised honours it at its next wave boundary and exits 84; the
    supervisor exits 0 with a drained generation."""
    script = tmp_path / "looping.py"
    script.write_text(
        "import sys, time\n"
        "import rocket_tpu_torch as rt\n"
        "class Slow(rt.Capsule):\n"
        "    def launch(self, attrs=None):\n"
        "        print('WAVE', flush=True)\n"
        "        time.sleep(0.05)\n"
        "runtime = rt.Runtime(device='cpu', project_dir=sys.argv[1])\n"
        "rt.Launcher([rt.Looper([Slow()], repeats=100000, progress=False)],\n"
        "            runtime=runtime).launch()\n")
    state_dir = tmp_path / "state"
    proc = subprocess.Popen([sys.executable, "-m", "rocket_tpu_torch.launch", "--supervise", "-n",
                             "1", "--drain-grace", "30", "--state-dir", str(state_dir),
                             str(script), str(tmp_path)], env=_env(), cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for line in proc.stdout:
            if "WAVE" in line:
                break
        proc.send_signal(__import__("signal").SIGTERM)
        rest = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    assert proc.returncode == 0, rest[-2000:]
    state = json.loads((state_dir / "supervisor.json").read_text())
    assert state["outcome"] == "drained" and state["drain_events"] == 1
    assert state["generations"][0]["exit_codes"] == [EXIT_DRAINED]
