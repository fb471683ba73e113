"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the reference loads nothing of the program."""
import json
import subprocess
import sys

from conftest import REPO

RUN_TINY = r"""
import json, pathlib, shutil, sys, tempfile, time
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
import torch, conftest
from gpubench.harness import core
tmp = pathlib.Path(tempfile.mkdtemp())
bench, root = conftest.tiny_copy(tmp)
for cell in ("audioapp-live", "sphere1m-4k-batch2"):
    core.run(bench, root, cell, 5, 0.2,
             cell == "audioapp-live", torch.device("cpu"),
             time.perf_counter(), log=lambda *a: None)
shutil.rmtree(tmp)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_gpubench_runs_load_no_jax_nor_the_jax_package():
    code = RUN_TINY.format(repo=str(REPO), tests=str(REPO / "gpubench" /
                                                      "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "metalrenderer_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "metalrenderer_tpu"}


def test_gpubench_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import gpubench.reference.audio, gpubench.reference.frame\n"
            "import gpubench.reference.scene, gpubench.reference.raster\n"
            "import gpubench.reference.obj\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))" % str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not tops & {"metalrenderer_tpu_torch", "metalrenderer_tpu",
                       "jax", "jaxlib"}


def test_gpubench_banned_names_are_compared_whole(monkeypatch):
    from gpubench.harness import core
    monkeypatch.setitem(sys.modules, "metalrenderer_tpu_torch_extra",
                        sys.modules["json"])
    assert core.banned_modules() == []
    monkeypatch.setitem(sys.modules, "metalrenderer_tpu.engine",
                        sys.modules["json"])
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        sys.modules["json"])
    assert core.banned_modules() == ["jaxlib", "metalrenderer_tpu"]
