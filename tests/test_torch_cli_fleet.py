"""`python -m madsim_tpu_torch fleet ...` against `python -m madsim_tpu
fleet ...`: every verb runs in a subprocess, the same sequence on a root
each package serves, and prints the same stdout once wall-clock figures,
times and the program name are masked (`serve`, `submit`, `status`,
`queue`, `cancel`, `worker` with the real driver on the CPU and the
synthetic one, `watch`, `result`, `timeline`, `profile`, `top`, `fsck`,
`chaos`). Then a real worker with no card and no `--device cpu` exits 2
before it leases anything, and `fleet submit --devices 2` files the
JAX package's spec.
"""

import os
import pathlib
import re
import subprocess
import sys
import time

from madsim_tpu_torch.fleet.store import QUEUED, JobStore

REPO = pathlib.Path(__file__).resolve().parents[1]
PROGS = {"jax": "madsim_tpu", "port": "madsim_tpu_torch"}
ECHO = ["--machine", "echo", "--seeds", "64", "--batch", "32", "--faults", "0", "--horizon", "1.0",
        "--max-steps", "200"]

# wall seconds (" in 0.3s", "+   1.23s"), stamps, and the trace-event
# tallies of the host plane (the two packages' workers record different
# host spans: `compile` against `engine_build`)
_MASKS = (
    (re.compile(r"\b1\d{9}(\.\d+)?\b"), "<ts>"),
    (re.compile(r" in \d+\.\ds"), " in <s>"),
    (re.compile(r"^\+ *\d+\.\d+s", re.M), "+<s>"),
    (re.compile(r"(elapsed_s|seeds_per_sec)=[\d.]+"), r"\1=<s>"),
    (re.compile(r'"(elapsed_s|seeds_per_sec)": [\d.]+'), r'"\1": <s>'),
    (re.compile(r"\d+ trace events \(\d+ lifecycle events, \d+ worker spans\), \d+%"), "<n> trace events"),
    (re.compile(r"profile: \d+ trace events, "), "profile: <n> trace events, "),
    (re.compile(r"\d+% attributed"), "<n>% attributed"),
)


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("MADSIM_TPU_FLEET_ROOT", None)
    env.pop("MADSIM_TPU_FLEET_ADDR", None)
    return env


def _run(pkg, *argv, cwd, timeout=300):
    out = subprocess.run([sys.executable, "-m", PROGS[pkg], *argv], cwd=cwd, env=_env(), capture_output=True,
                         text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr


def _masked(text, work):
    text = text.replace(work, "<work>").replace("madsim_tpu_torch", "madsim_tpu")
    for pat, rep in _MASKS:
        text = pat.sub(rep, text)
    return text


def _serve(pkg, root, port_file):
    proc = subprocess.Popen([sys.executable, "-m", PROGS[pkg], "fleet", "serve", "--root", root, "--addr",
                             "127.0.0.1:0", "--port-file", port_file, "--sweep-interval", "0"],
                            env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 60
    while not os.path.exists(port_file):
        assert proc.poll() is None and time.monotonic() < deadline, "fleet serve never wrote its port file"
        time.sleep(0.05)
    return proc


def _session(pkg, tmp_path):
    """The same verbs against a fleet served by `pkg`'s own command line,
    each in a subprocess: (rc, masked stdout) per step."""
    work = tmp_path / pkg
    work.mkdir()
    root, pf = str(work / "farm"), str(work / "farm.port")
    server = _serve(pkg, root, pf)
    steps = []

    def step(*argv, timeout=300):
        rc, out, err = _run(pkg, *argv, cwd=str(work), timeout=timeout)
        steps.append((argv[1], rc, _masked(out, str(work))))
        assert rc in (0, 1), (argv, err[-2000:])
        return out

    try:
        cli = ("--port-file", pf)
        worker = ("--root", root, "--worker-id", "w1", "--poll", "0.05", "--drain")
        # the synthetic driver (no engine) drains the chaos-* jobs, then
        # the real worker runs the echo job
        step("fleet", "submit", *cli, "--machine", "chaos-find", "--seeds", "48", "--batch", "16")
        doomed = step("fleet", "submit", *cli, "--machine", "chaos-echo", "--seeds", "48", "--priority",
                      "-1").strip()
        step("fleet", "cancel", *cli, doomed)
        step("fleet", "worker", *worker, "--driver", "synthetic")
        echo = step("fleet", "submit", *cli, *ECHO, "--tenant", "ci").strip()
        step("fleet", "status", *cli, echo, "--feed", "5")
        step("fleet", "queue", *cli)
        step("fleet", "worker", *worker, *(("--device", "cpu") if pkg == "port" else ()))
        step("fleet", "watch", *cli, echo)
        step("fleet", "result", *cli, echo)
        step("fleet", "timeline", *cli, echo, "--out", str(work / "t.json"))
        step("fleet", "profile", *cli, echo, "--out", str(work / "p.json"))
        step("fleet", "top", *cli, "--once")
        step("fleet", "fsck", "--root", root)
    finally:
        server.terminate()
        server.wait(timeout=30)
    return steps


def test_fleet_verbs_print_what_the_jax_command_line_prints(tmp_path):
    want, got = _session("jax", tmp_path), _session("port", tmp_path)
    assert [s[0] for s in got] == [s[0] for s in want]
    for (verb, rc, out), (_v, want_rc, want_out) in zip(got, want):
        assert (rc, out) == (want_rc, want_out), verb
    text = dict((verb, out) for verb, _rc, out in got)
    assert '"state": "exhausted"' in text["result"] and "reached terminal state 'exhausted'" in text["watch"]
    assert "all files ok" in text["fsck"] and "fleet top" in text["top"]


def test_fleet_chaos_claims_passes_on_both(tmp_path):
    """`fleet chaos --seed 3 --profile claims --workers 2` (synthetic
    driver) passes on both packages. Its round lines depend on when a
    stopped worker is caught, so the last line and the code are held."""
    last = {}
    for pkg in PROGS:
        rc, out, err = _run(pkg, "fleet", "chaos", "--seed", "3", "--profile", "claims", "--workers", "2",
                            cwd=str(tmp_path))
        assert rc == 0, (pkg, out[-2000:], err[-2000:])
        last[pkg] = out.strip().splitlines()[-1]
    assert last["port"] == last["jax"] == "fleet chaos: 1 seed(s) ok (profile claims, first seed 3)"


def test_real_worker_without_a_card_leases_nothing(tmp_path):
    """No card and no `--device cpu`: a real-driver worker exits 2 with
    the port's "no CUDA device" line before it leases, so the job stays
    queued with no lease, no attempt and no death (a lease would burn a
    poison attempt of a healthy job)."""
    root = str(tmp_path / "farm")
    job = JobStore(root).submit({"machine": "echo", "seeds": 32, "batch": 32, "faults": 0})
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['madsim_tpu_torch'] + sys.argv[1:]\n"
            "runpy.run_module('madsim_tpu_torch', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code, "fleet", "worker", "--root", root, "--drain"], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "no CUDA device" in out.stderr and out.stdout == ""
    doc = JobStore(root).get(job.id)
    assert doc.state == QUEUED and doc.lease is None and doc.attempt == 0 and not doc.deaths
    assert doc.lease_gen == 0 and [s for _t, s in doc.history] == [QUEUED]
    assert not os.path.exists(os.path.join(root, "workers"))
    # the synthetic driver builds no engine and needs no card
    out = subprocess.run([sys.executable, "-c", code, "fleet", "worker", "--root", str(tmp_path / "empty"),
                          "--drain", "--driver", "synthetic", "--worker-id", "ws"], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "worker ws: drained" in out.stdout


def test_mesh_submit_files_the_jax_packages_spec(tmp_path):
    """`fleet submit --devices 2` files a lane-sharded job: the spec the
    port's server stores, and the submit's stdout, are the JAX
    package's."""
    specs = {}
    for pkg in PROGS:
        work = tmp_path / pkg
        work.mkdir()
        root, pf = str(work / "farm"), str(work / "farm.port")
        server = _serve(pkg, root, pf)
        try:
            rc, out, err = _run(pkg, "fleet", "submit", "--port-file", pf, *ECHO, "--devices", "2", cwd=str(work))
        finally:
            server.terminate()
            server.wait(timeout=30)
        assert rc == 0, err[-2000:]
        specs[pkg] = (out, JobStore(root).get(out.strip()).spec)
    assert specs["port"] == specs["jax"] and specs["port"][1]["devices"] == 2
