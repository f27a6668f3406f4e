"""The port stands alone: importing every module of ``spnerf_tpu_torch``
and loading ``chip_smoke.py`` (without running it) loads no JAX, no flax,
no msgpack, cv2, yaml, PIL, imageio or torchvision (the card's machine
has none of them) and nothing of ``spnerf_tpu`` or ``demo``. Runs in a
fresh interpreter, since this test process has JAX loaded already."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, importlib.util, pkgutil, sys
import spnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(spnerf_tpu_torch.__path__,
                                               "spnerf_tpu_torch.")]
for name in ("kernels.desc_sample", "eval.pose", "eval.essential",
             "eval.cv_rng", "ops.quantization", "data.coco", "data.jpeg",
             "data.synthetic_shapes", "data.synthetic_draw",
             "data.photometric", "data.cv_draw", "data.cv_filter",
             "data.imread", "data.loader", "data.pnm", "tools.smoke_data",
             "parallel", "parallel.mesh", "parallel.distributed",
             "tools.smoke_dist", "data.cv_warp", "demo.run",
             "demo.standin_data", "demo.nerf_scenes", "demo.nerf_leg",
             "demo.gt_test_views", "demo.link_corpus", "demo.nerf_test_psnr",
             "demo.pose_stability", "tools.smoke_demo", "eval.sift",
             "demo.pose_baseline_classical", "eval.orb", "tools.orb_pattern",
             "demo.label_iou", "demo.label_fidelity", "demo.ha_rate",
             "demo.live_steps", "demo.multiproc_export", "probes.micro_conv2",
             "probes.micro_conv3", "probes.mxu_probe", "probes.gather_probe",
             "kernels.probe_conv", "kernels.probe_chain", "kernels.probe_gather",
             "tools.smoke_probes"):
    assert "spnerf_tpu_torch." + name in names, names
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert callable(smoke.main)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "cv2",
                                    "yaml", "PIL", "imageio", "torchvision",
                                    "spnerf_tpu", "demo"))
print(len(names), "modules;", "forbidden:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 50, proc.stdout


def test_chip_smoke_needs_a_card():
    """Without CUDA the script exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch, runpy; torch.cuda.is_available = lambda: False;"
         " sys.argv = ['chip_smoke.py']; runpy.run_path('chip_smoke.py',"
         " run_name='__main__')"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
