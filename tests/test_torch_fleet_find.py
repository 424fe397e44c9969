"""A fleet job that finds, on the JAX package's worker and on the port's
worker on the CPU: `demo-volatilecommit-raft` under strict restarts with
coverage and provenance, 64 seeds in batches of 32, one representative
find shrunk (provenance-guided), explained by its lineage word and
filed. Both workers run as a user runs them, `python -m ... fleet
worker --drain`, side by side.

Tolerance: the result documents and the fleet corpus files are the same
bytes once the store roots' paths, the program name in the repro lines
and each corpus entry's environment fingerprint (jax/jaxlib against
torch/CUDA versions) are masked.
"""

import json
import os
import pathlib
import subprocess
import sys

from madsim_tpu.fleet.store import JobStore as JaxStore
from madsim_tpu_torch.fleet.store import FILED, JobStore

REPO = pathlib.Path(__file__).resolve().parents[1]

SPEC = {"machine": "demo-volatilecommit-raft", "strict_restart": True, "seeds": 64, "batch": 32,
        "horizon": 1.0, "max_steps": 600, "queue": 64, "faults": 2, "fault_tmax": 600_000,
        "coverage": True, "provenance": True, "shrink_limit": 1}

# the environment an audit trail was recorded under, per package
_ENV_KEYS = {"madsim_tpu", "jax", "jaxlib", "madsim_tpu_torch", "torch", "cuda", "python"}


def _masked(text: str, root: str) -> str:
    return text.replace(root, "<root>").replace("madsim_tpu_torch", "madsim_tpu")


def test_finding_job_files_the_same_corpus_as_the_jax_worker(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    runs = {}
    for pkg, store_cls, extra in (("madsim_tpu", JaxStore, ()), ("madsim_tpu_torch", JobStore, ("--device", "cpu"))):
        root = str(tmp_path / pkg)
        job = store_cls(root).submit(dict(SPEC))
        proc = subprocess.Popen([sys.executable, "-m", pkg, "fleet", "worker", "--root", root, "--worker-id", "w",
                                 "--poll", "0.05", "--drain", *extra],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        runs[pkg] = (root, job.id, proc)
    docs = {}
    for pkg, (root, job_id, proc) in runs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (pkg, out[-2000:], err[-2000:])
        assert f"job {job_id}: filed 1 corpus entry from 24 failing seeds" in out
        job = JobStore(root).get(job_id)
        assert job.state == FILED
        with open(os.path.join(root, "corpus.json")) as f:
            corpus = json.load(f)
        for entry in corpus["entries"]:
            entry["meta"] = {k: v for k, v in entry["meta"].items() if k not in _ENV_KEYS}
        docs[pkg] = (_masked(json.dumps(job.result, sort_keys=True), root),
                     _masked(json.dumps(corpus, sort_keys=True), root))
    assert docs["madsim_tpu_torch"] == docs["madsim_tpu"]

    result = json.loads(docs["madsim_tpu_torch"][0])
    [find] = result["finds"]
    assert find["code"] == 102 and find["corpus_status"] == "added" and result["corpus_added"] == 1
    assert find["repro"].startswith("python -m madsim_tpu replay --machine demo-volatilecommit-raft --seed ")
    assert "strict-restart" in find["why"]["kinds"]
    [entry] = json.loads(docs["madsim_tpu_torch"][1])["entries"]
    assert entry["meta"]["filed_by"]["worker"] == "w" and entry["meta"]["why_kinds"] == find["why"]["kinds"]
    assert entry["digests"] and entry["meta"]["digest"] == "fr-v1"
