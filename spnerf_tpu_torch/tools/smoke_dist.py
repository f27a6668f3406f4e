"""Data parallelism on ``torch.distributed``: the rank processes, and the
``[dist]`` phase of ``chip_smoke.py``.

``spawn_ranks`` starts N processes of this module with the variables
``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``); each joins the group by
``parallel.distributed.maybe_initialize_distributed``, runs one of the
``JOBS`` on the payload file the caller wrote, and saves what it returns
to ``<out>/rank<r>.pt``. The jobs take their sizes from the payload, so
that the CPU tests (``tests/test_torch_parallel*.py``, gloo, narrow
models) and the card (full width) run the same code:

- ``bn``: one BatchNorm training forward and backward over the ranks;
- ``apply``: ``train.loop.apply_step`` on prepared data and noise that
  the caller made for the global batch (each rank takes its rows);
- ``step``: ``train.loop.train_step`` on a global host batch;
- ``train``: ``tasks.train_task.train`` over global host batches;
- ``export``: ``tasks.export.export_pseudo_labels`` sharded by the mesh;
- ``cli``: ``cli.main`` in the group the process has joined;
- ``multi``: several of these in turn.

``phase_dist`` is the ``[dist]`` phase: on one card, two ranks through
gloo (NCCL takes one rank per card) export HA labels sharded by the mesh
(int8 serving), export through ``cli.main`` with ``data.shard: auto``,
and take a SuperPoint step, each held against the same work in one
process; one rank through NCCL takes the step bit-equal to the step
without a group; and the kernels of rows 1-4, 9, 10 and 11 must have
been launched on the sharded path. Imports nothing of the JAX package.

    python -m spnerf_tpu_torch.tools.smoke_dist --job NAME --payload FILE \\
        --out DIR [--backend gloo|nccl] [--device cpu|cuda] [--threads N]
    python -m spnerf_tpu_torch.tools.smoke_dist --probe DIR
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from spnerf_tpu_torch import cli, settings
from spnerf_tpu_torch.data.loader import DataLoader
from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.models.superpoint import BatchNorm, SuperPoint, SuperPointConfig
from spnerf_tpu_torch.parallel import mesh as dp
from spnerf_tpu_torch.parallel.distributed import maybe_initialize_distributed
from spnerf_tpu_torch.tasks import export
from spnerf_tpu_torch.tasks.train_task import _to_device
from spnerf_tpu_torch.train import loop

ROOT = Path(__file__).resolve().parents[2]


# ------------------------------------------------------------ rank processes


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankRun:
    """The processes of one ``spawn_ranks`` call."""

    def __init__(self, procs, out: Path, timeout: float):
        self.procs, self.out, self.timeout = procs, out, timeout

    def wait(self) -> list:
        """Every rank's result, in rank order. Raises, with the end of its
        output, when a rank fails or the time runs out; the other ranks
        are then stopped."""
        deadline = time.monotonic() + self.timeout
        failed = None
        while failed is None:
            codes = [proc.poll() for proc in self.procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (bad[0], f"exit code {codes[bad[0]]}")
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failed = (codes.index(None), "timed out")
            else:
                time.sleep(0.05)
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if failed is not None:
            r, why = failed
            log = (self.out / f"rank{r}.log").read_text()[-6000:]
            raise RuntimeError(f"rank {r} of {len(self.procs)}: {why}\n{log}")
        return [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                for r in range(len(self.procs))]


def spawn_ranks(job_name: str, world: int, payload: dict, out: Path, *,
                backend: str = "gloo", device: str = "cpu",
                threads: int | None = None, timeout: float = 300.0,
                env: dict | None = None) -> RankRun:
    """Start ``world`` ranks running ``job_name`` on ``payload``, with
    ``env`` added to their environment; returns at once (``RankRun.wait``
    collects). Every rank gets ``LOCAL_RANK`` 0: on the card all ranks
    share card 0, which only gloo allows."""
    out.mkdir(parents=True, exist_ok=True)
    torch.save(payload, out / "payload.pt")
    port = free_port()
    procs = []
    path = [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    for r in range(world):
        rank_env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port), WORLD_SIZE=str(world),
                        RANK=str(r), LOCAL_RANK="0",
                        PYTHONPATH=os.pathsep.join(path), **(env or {}))
        argv = [sys.executable, "-m", __name__, "--job", job_name, "--payload",
                str(out / "payload.pt"), "--out", str(out), "--backend",
                backend, "--device", device]
        if threads:
            argv += ["--threads", str(threads)]
        with open(out / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(argv, cwd=ROOT, env=rank_env,
                                          stdout=log,
                                          stderr=subprocess.STDOUT))
    return RankRun(procs, out, timeout)


def rank_main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--probe", metavar="DIR",
                   help="print what gloo and NCCL do with two ranks on "
                        "card 0 (probe_backends), working in DIR")
    p.add_argument("--job")
    p.add_argument("--payload")
    p.add_argument("--out")
    p.add_argument("--backend", default="gloo")
    p.add_argument("--device", default="cpu")
    p.add_argument("--threads", type=int, default=0)
    args = p.parse_args(argv)
    if args.probe:
        for r, answer in enumerate(probe_backends(Path(args.probe))):
            print(f"rank {r}: {json.dumps(answer)}", flush=True)
        return 0
    if args.threads:
        torch.set_num_threads(args.threads)
    payload = torch.load(args.payload, weights_only=False)
    device = torch.device(args.device)
    maybe_initialize_distributed(backend=args.backend, device=device)
    mesh = dp.make_mesh()
    try:
        result = JOBS[args.job](payload, mesh, device)
        torch.save(result, Path(args.out, f"rank{mesh.rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


# ----------------------------------------------------------------- the jobs


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def load_state(payload: dict, device) -> loop.TrainState:
    """The ``TrainState`` of ``payload``: "model" (SuperPointConfig
    fields), "state" (a ``loop.checkpoint_payload``), "lr"."""
    model = SuperPoint(SuperPointConfig(**payload["model"])).to(device)
    saved = payload["state"]
    params, stats = loop.model_params(model), loop.model_batch_stats(model)
    if (len(loop.partial_restore(params, saved["params"])) != len(params)
            or len(loop.partial_restore(stats, saved["batch_stats"]))
            != len(stats)):
        raise ValueError("the saved state does not fit the model")
    state = loop.create_train_state(model, payload["lr"])
    # a copy: Adam would otherwise step the payload's own moments
    state.optimizer.load_state_dict(copy.deepcopy(saved["opt_state"]))
    state.iteration = int(saved["iteration"])
    return state


def step_result(state: loop.TrainState, metrics: dict) -> dict:
    """What a step job returns: the metrics, and copies of the state after
    the step and of the gradients it applied, on the CPU."""
    return copy.deepcopy({
        "metrics": {k: float(v) for k, v in metrics.items()},
        "state": loop.checkpoint_payload(state),
        "grads": {k: p.grad.detach().cpu()
                  for k, p in state.model.named_parameters()
                  if p.grad is not None}})


def run_bn(payload: dict, mesh: dp.Mesh, device) -> dict:
    """BatchNorm's training forward on this rank's rows of "x" (N, C, H,
    W), the backward of sum(sin(out)): out and x.grad rows, weight and
    bias gradients summed over the ranks, the running statistics."""
    x = torch.as_tensor(payload["x"])
    mod = BatchNorm(x.shape[1], eps=1e-5, momentum=0.1).to(device).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(mod, name).copy_(torch.as_tensor(payload[name]))
    xr = x[mesh.rows(len(x))].to(device).requires_grad_()
    with dp.data_parallel(mesh):
        out = mod(xr)
        torch.sin(out).sum().backward()
    dp.sum_gradients(mod.parameters(), mesh)
    return {"out": out.detach().cpu(), "x_grad": xr.grad.cpu(),
            "weight_grad": mod.weight.grad.cpu(),
            "bias_grad": mod.bias.grad.cpu(),
            "running_mean": mod.running_mean.cpu(),
            "running_var": mod.running_var.cpu()}


def _rows(tree, mesh: dp.Mesh):
    if isinstance(tree, tuple):
        return tuple(_rows(t, mesh) for t in tree)
    return dp.shard_batch(tree, mesh)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(t, device) for t in tree)
    return torch.as_tensor(tree).to(device)


def run_apply(payload: dict, mesh: dp.Mesh, device) -> dict:
    """``loop.apply_step`` on this rank's rows of "data" and "noise" (the
    prepared global batch, and its noise: a tensor or a (raw, warped)
    pair) from the state of ``load_state``, with "step_cfg". "local":
    the losses' normalisers left to each rank, as a per-rank mean with
    averaged gradients has them (a check that this is caught)."""
    state = load_state(payload, device)
    data = _to(_rows(payload["data"], mesh), device)
    noise = _to(_rows(payload["noise"], mesh), device)
    with contextlib.ExitStack() as stack:
        if payload.get("local"):
            stack.enter_context(_patched(dp, "batch_sum",
                                         lambda x: x * mesh.size))
        metrics = loop.apply_step(state, data, noise, payload["step_cfg"],
                                  mesh)
    return step_result(state, metrics)


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def run_step(payload: dict, mesh: dp.Mesh, device) -> dict:
    """``loop.train_step`` on this rank's rows of the global host batch
    "batch" from the state of ``load_state``, the generators seeded by
    "seed"; its launches, then the ms of "timed_steps" more steps. With
    "deterministic", under ``torch.use_deterministic_algorithms``."""
    torch.use_deterministic_algorithms(bool(payload.get("deterministic")),
                                       warn_only=True)
    state = load_state(payload, device)
    gens = loop.StepGenerators(payload["seed"], device)
    batch = _to_device(dp.shard_batch(payload["batch"], mesh), device)
    _build.launch_counts.clear()
    metrics = loop.train_step(state, batch, payload["step_cfg"], gens, mesh)
    result = step_result(state, metrics)
    result["launches"] = dict(_build.launch_counts)
    result["ms"] = []
    for _ in range(payload.get("timed_steps", 0)):
        _sync(device)
        t0 = time.perf_counter()
        loop.train_step(state, batch, payload["step_cfg"], gens, mesh)
        _sync(device)
        result["ms"].append((time.perf_counter() - t0) * 1e3)
    return result


def run_train(payload: dict, mesh: dp.Mesh, device) -> dict:
    """``train_task.train`` of "config" over "batches" (global host
    batches) from "seed", with CKPT_PATH "CKPT_PATH"/rank<r>: the state
    it returns with its last gradients, the files the rank wrote, and
    its launches."""
    from spnerf_tpu_torch.tasks.train_task import train

    root = Path(payload["CKPT_PATH"], f"rank{mesh.rank}")
    settings.CKPT_PATH = root
    _build.launch_counts.clear()
    state = train(payload["config"], payload["batches"], seed=payload["seed"],
                  device=device)
    metrics = root / payload["config"]["ckpt_name"] / "logs" / "metrics.jsonl"
    result = step_result(state, {})
    result["metrics"] = {}
    if metrics.exists():  # the loss as rank 0 logged it, step by step
        for line in metrics.read_text().splitlines():
            row = json.loads(line)
            if row["tag"] == "iter_loss/loss":
                result["metrics"][row["step"]] = row["value"]
    result["written"] = sorted(str(p.relative_to(root))
                               for p in root.rglob("*") if p.is_file())
    result["launches"] = dict(_build.launch_counts)
    return result


def _settings(payload: dict) -> None:
    for name in ("DATA_PATH", "EXPER_PATH", "CKPT_PATH"):
        if name in payload:
            setattr(settings, name, Path(payload[name]))
    if "EXPER_PATH" in payload:
        export.EXPER_PATH = Path(payload["EXPER_PATH"])


def export_model(payload: dict, device) -> SuperPoint:
    model = SuperPoint(SuperPointConfig(**payload["model"]))
    model.load_state_dict(payload["weights"])
    return model.to(device).eval()


def run_export(payload: dict, mesh: dp.Mesh, device) -> dict:
    """``export_pseudo_labels`` of "images" ((n, H, W, 1) float, named
    img0000, ...) in batches of the config's batch size, sharded by the
    mesh, into "EXPER_PATH"; its launches, seconds and ms per batch."""
    _settings(payload)
    model = export_model(payload, device)
    config = payload["config"]
    data = [{"image": im, "name": f"img{i:04d}"}
            for i, im in enumerate(payload["images"])]
    loader = DataLoader(data, config["data"]["batch_size"], drop_last=False)
    _build.launch_counts.clear()
    _sync(device)
    t0 = time.perf_counter()
    out = export.export_pseudo_labels(config, model, loader,
                                      seed=payload.get("seed", 0),
                                      device=device, mesh=mesh)
    _sync(device)
    secs = time.perf_counter() - t0
    return {"dir": str(out), "launches": dict(_build.launch_counts),
            "seconds": secs, "ms_per_batch": secs / len(loader) * 1e3}


def run_cli(payload: dict, mesh: dp.Mesh, device) -> dict:
    """``cli.main(payload["argv"])`` in the group this rank has joined."""
    _settings(payload)
    _build.launch_counts.clear()
    out = cli.main(payload["argv"])
    return {"dir": str(out), "launches": dict(_build.launch_counts)}


def run_multi(payload: dict, mesh: dp.Mesh, device) -> list:
    """The jobs of "jobs" ([(name, payload), ...]) in turn."""
    return [JOBS[name](sub, mesh, device) for name, sub in payload["jobs"]]


def run_nccl_step(payload: dict, mesh: dp.Mesh, device) -> dict:
    """``run_step`` without a process group, then again from the same
    state in a one-rank NCCL group: the results of both, and whether
    ``maybe_initialize_distributed`` saw the group."""
    free = run_step(payload, dp.make_mesh(), device)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    seen = maybe_initialize_distributed(device=device)
    grouped = run_step(payload, dp.make_mesh(), device)
    return {"free": free, "grouped": grouped, "seen": seen,
            "backend": dist.get_backend()}


def run_probe(payload: dict, mesh: dp.Mesh, device) -> dict:
    """What the group's backend does with tensors on ``device``
    (``all_reduce``, ``broadcast``, ``all_gather``), and what an NCCL
    group over the same ranks does with an ``all_reduce``: "ok" or the
    first line of the error."""
    def attempt(fn):
        try:
            fn()
            _sync(device)
            return "ok"
        except Exception as e:  # noqa: BLE001 - the answer is the error
            return f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"

    x = torch.full((4,), float(mesh.rank + 1), device=device)
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    result = {"backend": dist.get_backend(),
              "all_reduce": attempt(lambda: dist.all_reduce(x.clone())),
              "broadcast": attempt(lambda: dist.broadcast(x.clone(), 0)),
              "all_gather": attempt(lambda: dist.all_gather(out, x))}
    if payload.get("nccl"):
        result["nccl_all_reduce"] = attempt(lambda: dist.all_reduce(
            x.clone(), group=dist.new_group(backend="nccl")))
    return result


def probe_backends(root: Path, world: int = 2, timeout: float = 120.0):
    """``run_probe`` on ``world`` ranks of card 0 joined by gloo, with an
    NCCL group over them: [per-rank answers]. Where NCCL hangs rather
    than fails, the ranks are stopped at ``timeout``."""
    return spawn_ranks("probe", world, {"nccl": True}, root, backend="gloo",
                       device="cuda", timeout=timeout).wait()


JOBS = {"bn": run_bn, "apply": run_apply, "step": run_step,
        "train": run_train, "export": run_export, "cli": run_cli, "multi": run_multi,
        "nccl_step": run_nccl_step, "probe": run_probe}


# ------------------------------------------------------- the [dist] phase

DIST_DEVICE = "cuda"
DIST_IMAGES = 16
DIST_RANKS = 2
DIST_TIMED_STEPS = 3
DIST_TIMEOUT_S = 240
# the DP step against the one-process step (``compare_steps``): float32
# sums over the ranks in another order. The metrics hold the losses'
# normalisers and the draws. The gradient of a conv in front of a
# training BatchNorm is a sum of terms that cancel along its input's
# mean (as its bias's gradient, 0, is): at full width another order of
# the sums moves it by up to 3.4e-2 of the tensor's largest entry on the
# H100 (backbone block 6, the loss bit-equal). A gradient left unsummed
# is off by half of it.
DIST_METRIC_RTOL = 1e-6
DIST_GRAD_TOL = 0.1  # of the tensor's largest entry
DIST_STEP_TOL = 1e-3  # of lr, on gradients clear of DIST_GRAD_TOL
DIST_BIAS_GRAD_TOL = 1e-4
# the steps run under torch.use_deterministic_algorithms, with cuBLAS's
# deterministic workspace
DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def log(msg: str) -> None:
    print(msg, flush=True)


def files(out_dir) -> dict:
    """{name: bytes} of the label files under ``out_dir``."""
    return {p.name: p.read_bytes() for p in sorted(Path(out_dir).glob("*.npy"))}


def same_files(what: str, got: dict, want: dict) -> None:
    if set(got) != set(want) or not want:
        raise AssertionError(f"{what}: files {sorted(got)} against "
                             f"{sorted(want)}")
    differ = sorted(n for n in want if got[n] != want[n])
    if differ:
        raise AssertionError(f"{what}: {len(differ)} files differ from the "
                             f"one-process export: {differ[:5]}")


def compare_steps(got: dict, want: dict, lr: float, metric_rtol: float,
                  grad_tol: float, step_tol: float,
                  bias_grad_tol: float) -> dict:
    """A data-parallel step (``step_result``) against the one-process
    step from the same state: every metric (the losses and the distance
    summaries, each a sum of the ranks' shares) within ``metric_rtol``;
    the summed gradients within ``grad_tol`` of the tensor's largest
    entry; the parameters within 2 lr (Adam's step bound) everywhere and
    within ``step_tol`` lr where the gradient is clear of rounding and of
    ``grad_tol`` (above the larger of 1e-3 and ``grad_tol`` of the
    tensor's largest: Adam's first step, lr * g / (|g| + 1e-8), turns a
    smaller gradient's error into a move of up to lr). The conv biases in
    front of a training BatchNorm, whose gradient is rounding noise, are
    held to ``bias_grad_tol`` and 2 lr. Raises AssertionError; returns
    the worst of each: {"metric": (relative difference, name), "grad":
    (difference over the tensor's largest entry, tensor), "step":
    (difference on clear gradients over lr, tensor)}."""
    worst = {"metric": (0.0, ""), "grad": (0.0, ""), "step": (0.0, "")}
    for k, value in want["metrics"].items():
        off = abs(got["metrics"][k] - value) / max(abs(value), 1e-30)
        if off > metric_rtol:
            raise AssertionError(f"{k} {got['metrics'][k]!r} against "
                                 f"{value!r}")
        worst["metric"] = max(worst["metric"], (off, k))
    for k, v in want["state"]["params"].items():
        diff = (got["state"]["params"][k] - v).abs()
        if float(diff.max()) > 2.002 * lr:
            raise AssertionError(f"{k} moved {float(diff.max())}, above 2 lr")
        g, g_want = got["grads"][k], want["grads"][k]
        if k.endswith("Conv_0.bias"):
            if float(g.abs().max()) >= bias_grad_tol:
                raise AssertionError(f"{k}: gradient {float(g.abs().max())}")
            continue
        scale = float(g_want.abs().max())
        off = float((g - g_want).abs().max()) / scale
        if off > grad_tol:
            raise AssertionError(f"{k}: gradient off by {off:.3e} of its "
                                 f"largest entry")
        clear = g_want.abs() > max(1e-3, grad_tol) * scale
        if float(clear.float().mean()) == 0.0:
            raise AssertionError(f"{k}: no clear gradient")
        step = float(diff[clear].max()) / lr
        if step > step_tol:
            raise AssertionError(f"{k} off by {step:.3e} lr")
        worst["grad"] = max(worst["grad"], (off, k))
        worst["step"] = max(worst["step"], (step, k))
    return worst


def sharded_launches(export_launches: dict, step_launches: dict,
                     ha: dict, n_batches: int) -> dict:
    """A rank's launches by kernel family, checked against what its share
    of ``n_batches`` HA batches and one training step launch: the warp
    twice a chunk, the int8 forward once per chunk and identity view,
    rows 10-11 once."""
    n_chunks = -(-(ha["num"] - 1) // ha["chunk"])
    fwd = (n_chunks + 1) * n_batches
    want = {"warp": 2 * n_chunks * n_batches, "conv12_fused": fwd,
            "double_conv3x3": 3 * fwd, "head": fwd, "desc_loss[fwd]": 1,
            "desc_loss[dA]": 1, "desc_loss[dB]": 1}
    counts = collections.Counter(export_launches)
    counts.update(step_launches)
    got = {f: sum(v for k, v in counts.items() if k.startswith(f))
           for f in want}
    if got != want:
        raise AssertionError(f"launches {got}, expected {want}")
    return counts


def write_coco(root: Path, images: np.ndarray) -> None:
    """``images`` as the PNGs of a COCO-layout training split."""
    from spnerf_tpu_torch.data.png import write_gray

    coco = root / "data" / "COCO" / "images" / "training"
    coco.mkdir(parents=True)
    for i, im in enumerate(images):
        write_gray(coco / f"img{i:04d}.png",
                   np.clip(np.rint(im[..., 0] * 255.0), 0, 255)
                   .astype(np.uint8))


def save_weights(model: SuperPoint, path: Path) -> None:
    """``model``'s parameters and statistics as a checkpoint that
    ``restore_pretrained`` reads."""
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"iteration": 0,
                "params": {k: v.detach().cpu() for k, v in
                           loop.model_params(model).items()},
                "batch_stats": {k: v.cpu() for k, v in
                                loop.model_batch_stats(model).items()}}, path)


@contextlib.contextmanager
def _kept_settings():
    saved = (settings.DATA_PATH, settings.CKPT_PATH, settings.EXPER_PATH,
             export.EXPER_PATH)
    try:
        yield
    finally:
        (settings.DATA_PATH, settings.CKPT_PATH, settings.EXPER_PATH,
         export.EXPER_PATH) = saved


def phase_dist(root: Path, model: SuperPoint, images: np.ndarray,
               export_config: dict, train_config: dict, train_batch: dict,
               seed: int) -> collections.Counter:
    """The ``[dist]`` phase (see the module's docstring) on card 0
    (``DIST_DEVICE``).
    ``model``: the HA MagicPoint; ``images``: (n, H, W, 1) float;
    ``export_config``: magicpoint_coco_export.yaml with int8 serving;
    ``train_config``: superpoint_coco_train.yaml; ``train_batch``: a
    global host batch of its batch size. Returns the launches on the
    sharded path, summed over the ranks."""
    from spnerf_tpu_torch.models.superpoint import init_superpoint
    from spnerf_tpu_torch.tasks.train_task import build_step_config, train

    dev = DIST_DEVICE
    lr = float(train_config["train"]["learning_rate"])
    sp_cfg = SuperPointConfig.from_dict(train_config["model"])
    sp = init_superpoint(seed, sp_cfg, device=dev)
    step_payload = {
        "model": {"model_name": sp_cfg.model_name, "vgg_cn": sp_cfg.vgg_cn,
                  "detector_dim": sp_cfg.detector_dim,
                  "descriptor_dim": sp_cfg.descriptor_dim},
        "lr": lr, "seed": seed, "batch": train_batch,
        "step_cfg": build_step_config(train_config, include_mask=True),
        "deterministic": True,
        "state": loop.checkpoint_payload(loop.create_train_state(sp, lr))}
    del sp
    one_step = dict(train_config, save_or_validation_interval=1, log_every=1,
                    ckpt_name="dist", train=dict(train_config["train"],
                                                 num_iters=1))
    # the CLI reads the export's own config (JSON is YAML) and the HA
    # model's weights from a checkpoint
    write_coco(root, images)
    save_weights(model, root / "ckpt" / "pretrained" / "ha_model.ckpt")
    cli_config = root / "export.yaml"
    cli_config.write_text(json.dumps(
        dict(export_config, pretrained="pretrained/ha_model.ckpt"), indent=1))
    argv = ["--config-path", str(cli_config), "--task",
            "export_pseudo_labels", "--device", dev]
    paths = {"DATA_PATH": str(root / "data"), "CKPT_PATH": str(root / "ckpt")}
    export_payload = {
        "model": {"model_name": model.config.model_name,
                  "vgg_cn": model.config.vgg_cn,
                  "detector_dim": model.config.detector_dim},
        "config": export_config, "images": images, "seed": seed,
        "weights": {k: v.cpu() for k, v in model.state_dict().items()}}

    jobs = [("export", dict(export_payload, EXPER_PATH=str(root / "mesh"))),
            ("export", dict(export_payload, EXPER_PATH=str(root / "again"))),
            ("cli", dict(paths, EXPER_PATH=str(root / "cli-auto"),
                         argv=argv + ["--set", "data.shard=auto"])),
            ("train", {"config": one_step, "batches": [train_batch],
                       "seed": seed, "CKPT_PATH": str(root / "train")}),
            ("step", dict(step_payload, timed_steps=DIST_TIMED_STEPS))]
    t0 = time.perf_counter()
    pair = spawn_ranks("multi", DIST_RANKS, {"jobs": jobs}, root / "gloo",
                       backend="gloo", device=dev, timeout=DIST_TIMEOUT_S,
                       env=DETERMINISTIC_ENV)
    solo = spawn_ranks("nccl_step", 1, step_payload, root / "nccl",
                       backend="nccl", device=dev, timeout=DIST_TIMEOUT_S,
                       env=DETERMINISTIC_ENV)

    # the same work in this process while the ranks start
    with _kept_settings():
        single = run_export(dict(export_payload,
                                 EXPER_PATH=str(root / "single")),
                            dp.Mesh(), dev)["dir"]
        _settings(dict(paths, EXPER_PATH=str(root / "cli-single")))
        cli_single = cli.main(argv)
        settings.CKPT_PATH = root / "train-single"
        train(one_step, [train_batch], seed=seed, device=dev)
        logged = [json.loads(line) for line in (
            root / "train-single" / "dist" / "logs" / "metrics.jsonl")
            .read_text().splitlines()]
    try:
        one = run_step(dict(step_payload, timed_steps=DIST_TIMED_STEPS),
                       dp.Mesh(), dev)
    finally:
        torch.use_deterministic_algorithms(False)

    try:
        ranks = pair.wait()
    finally:
        nccl = solo.wait()[0]
    secs = time.perf_counter() - t0

    mesh_export, again, cli_auto, trained, dp_step = zip(*ranks)
    same_files("[dist] HA export sharded by the mesh",
               files(mesh_export[0]["dir"]), files(single))
    same_files("[dist] cli export with data.shard: auto",
               files(cli_auto[0]["dir"]), files(cli_single))
    for results in (trained, dp_step):
        for key in ("params", "batch_stats"):
            for name, a in results[0]["state"][key].items():
                if not torch.equal(a, results[1]["state"][key][name]):
                    raise AssertionError(f"[dist] {name} differs between "
                                         "the ranks after the step")
    try:
        worst = compare_steps(dp_step[0], one, lr, DIST_METRIC_RTOL,
                              DIST_GRAD_TOL, DIST_STEP_TOL,
                              DIST_BIAS_GRAD_TOL)
    except AssertionError as e:
        raise AssertionError(f"[dist] DP step against one process: {e}") \
            from None
    want = next(r["value"] for r in logged if r["tag"] == "iter_loss/loss")
    if (trained[1]["written"] != [] or set(trained[0]["written"]) != {
            "dist/dist_1.ckpt", "dist/logs/metrics.jsonl"}
            or not abs(trained[0]["metrics"][1] - want)
            <= DIST_METRIC_RTOL * abs(want)):
        raise AssertionError(f"[dist] train(): ranks wrote "
                             f"{[t['written'] for t in trained]}, loss "
                             f"{trained[0]['metrics']} against {want!r}")
    if nccl["free"]["metrics"] != nccl["grouped"]["metrics"] or not all(
            torch.equal(v, nccl["grouped"]["state"]["params"][k])
            for k, v in nccl["free"]["state"]["params"].items()):
        raise AssertionError(
            f"[dist] NCCL one-rank step {nccl['grouped']['metrics']} "
            f"against {nccl['free']['metrics']}")
    if not nccl["seen"] or nccl["backend"] != "nccl":
        raise AssertionError(f"[dist] NCCL group: seen {nccl['seen']}, "
                             f"backend {nccl['backend']}")

    ha = export_config["homography_adaptation"]
    b = export_config["data"]["batch_size"]
    counts = collections.Counter()
    for r in range(DIST_RANKS):
        try:
            counts.update(sharded_launches(
                mesh_export[r]["launches"], dp_step[r]["launches"], ha,
                -(-len(images) // b)))
        except AssertionError as e:
            raise AssertionError(f"[dist] rank {r}: {e}") from None
    batch_ms = ", ".join(f"{x['ms_per_batch']:.3f}" for x in again)
    log(f"[dist] 2 ranks on card 0 through gloo: HA export of {len(images)} "
        f"images of {images.shape[1]}x{images.shape[2]} (int8 serving, "
        f"{ha['num']} views, batches of {b}, {b // DIST_RANKS} per rank) "
        f"byte-equal to one process's; ms per sharded batch by rank, second "
        f"run: {batch_ms}; cli.main export with data.shard: auto byte-equal "
        f"to one process's")
    loss = dp_step[0]["metrics"]["loss"]
    want_loss = one["metrics"]["loss"]
    step_ms = ", ".join(f"{statistics.median(x['ms']):.3f}" for x in dp_step)
    log(f"[dist] DP step of superpoint_coco_train.yaml (batch "
        f"{len(train_batch['image'])}, blockwise loss): loss {loss!r}, one "
        f"process {want_loss!r} (rel "
        f"{abs(loss - want_loss) / abs(want_loss):.3e}), every metric within "
        f"{worst['metric'][0]:.3e} ({worst['metric'][1]}); gradients within "
        f"{worst['grad'][0]:.3e} of their largest entry ({worst['grad'][1]}"
        f"); parameters on gradients clear of {DIST_GRAD_TOL} within "
        f"{worst['step'][0]:.3e} lr ({worst['step'][1]}); ranks "
        f"bit-equal; ms per DP step by rank (median of {DIST_TIMED_STEPS}): "
        f"{step_ms}, one process {statistics.median(one['ms']):.3f}; "
        f"train() on 2 ranks: rank 0 alone wrote, loss "
        f"{trained[0]['metrics'][1]!r} against {want!r}")
    log(f"[dist] 1 rank through NCCL: step bit-equal to the step without a "
        f"group (loss {nccl['grouped']['metrics']['loss']!r}); phase "
        f"{secs:.1f} s")
    log(f"[dist] launches on the sharded path (both ranks): "
        f"{dict(sorted(counts.items()))}")
    return counts


if __name__ == "__main__":
    sys.exit(rank_main())
