"""Smoke run of the PyTorch/CUDA port (spnerf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. build the CUDA kernels from ``spnerf_tpu_torch/kernels/csrc`` with
   nvcc (one process per source, all at once) into ``build/``;
2. print the card's name and power limit (nvidia-smi);
3. run the int8 SuperPoint serving path once at 480 x 640, batch 64,
   recording the operands of every kernel call, then call each kernel
   on those operands and hold it against its plain PyTorch version
   (int8 exactly equal, bf16 within 1 ulp), timing the kernel, the plain
   version and the least time the card could take;
4. answer 5 requests of batch 64 through ``build_inference`` (seeded
   full-width SuperPoint, calibrated on 8 images, det_thresh 0.015,
   top_k = num_candidates = 1024) with the launch counters set to 0 just
   before, check the outputs and that every kernel launched 5 times,
   then time the serving graph apart from detection + sampling;
5. hold the CUDA graph against the plain path on the CPU on a small
   input;
5b. the other serving routes through ``build_inference``, each with its
   kernels held against their plain versions on one request's operands
   (int8 equal; bf16 within 2 ulps, at most 0.1% beyond 1; with times,
   bounds and cuDNN / addmm / ``_int_mm`` yardsticks), then its requests
   with the launch counters at 0 before (every kernel of the route
   launched its count per request, no other), the outputs checked and
   frames/s and the graph / detection split printed: ``[slice-bf16]``
   and ``[slice-mixed]`` (5 requests of batch 64 at 480 x 640; bf16 runs
   conv1 as a plain conv above batch 8, block 2 through
   ``packed_conv3x3``), ``[slice-unfused]`` (fused mid and tail off,
   int8 and bf16, 5 requests of batch 8; bf16 runs ``conv1_packed``; and
   one int8 request of batch 8 at 480 x 632 with the fused flags on,
   where the mid drops to per-layer kernels by itself);
   Every kernel row also carries ``device_ms`` (and the library call
   ``library_device_ms``): the device time alone, by ``torch.profiler``
   over 20 calls, beside the wrapper's ``ms`` (CUDA events around one
   call, host work included);
5b'. hold the tensor-core head (bf16, at 80 x 30 x 40 and 1 x 7 x 13),
   ``dot_bias_act`` (int8 equal, bf16; and conv1's float32 instance; at
   M 1, 63, 65, 129 and 37,920) and ``conv12_fused`` on the int8 tensor
   cores (equal; at 1 x 7 x 13 unpooled, 2 x 40 x 56 pooled and not, 3 x
   34 x 632 pooled) against their plain versions, on operands prepared
   once, a call on raw weights and a second launch giving the same bits;
   and the warp at W 52-55 and 131 (N = 3 B, a zero denominator) within
   1e-6;
5c. hold the bf16, mixed and unfused graphs on the card against the CPU
   plain path at 2 x 32 x 64 and 2 x 32 x 56;
5d. count the images of the int8 requests that hold a run of equal
   probabilities at the 1,024-candidate cut, and time the defined tie
   order's top-k against a plain ``torch.topk``; then the fused bicubic
   descriptor sampler (``kernels/desc_sample.py``, on no serving path of
   the reference) on five operand sets with the launch counters at 0:
   one request's ``desc_raw`` and candidates, the shapes of
   ``benchmarks/micro_desc_sample.py`` (K 1,000) and border and corner
   points (the ring instance), the request's map in float32 and a 480 x
   960 frame's bf16 map (the gather instance), each counted under the
   instance its shape takes, with the share of an image's points that
   the ring's fullest band holds; held against its plain version (within 1e-6
   on the unit vectors, two runs bit-equal) and the request's own one-hot
   output (within 2e-6), timed (and its device time by the profiler)
   beside the plain version, the one-hot product, ``F.grid_sample`` +
   normalize and the bound;
5e. export HPatches bundles with ``tasks.export.export_hpatches`` through
   the parity path (``superpoint_inference``, float32, TF32 off) at
   ``magicpoint_repeatability.yaml`` (16 synthetic pairs, 240 x 320) and
   ``superpoint_descriptors.yaml`` (2 pairs, 480 x 640, dense
   descriptors), the MagicPoint weights restored from the JAX package's
   ``demo/pretrained/demo_mp_5000.ckpt`` by the port's msgpack reader
   (the descriptor head from seed 0); check every bundle and print
   pairs/s; then 2 pairs of 64 x 80 on the card and on the CPU: heatmaps
   and descriptors within 1e-5, keypoint sets equal away from the
   threshold and NMS near-ties;
6. export homographic-adaptation pseudo-labels with
   ``tasks.export.export_pseudo_labels`` at the configuration of
   ``spnerf_tpu_torch/configs/magicpoint_coco_export.yaml`` (full-width seeded
   MagicPoint, 240 x 320, batch 8, 100 views in chunks of 10) for 20
   synthetic images, by four routes, each with the launch counters at 0
   before: (a) the default BN-folded bf16 forward, (b) ``export.serving:
   int8`` on the int8 kernels, (c) one batch with int8 warps, (d)
   ``export.serving: mixed`` (int8 backbone, bf16 head); check one
   int64 (N, 2) label file per image and the launch counts, print
   images/s and split one batch into its parts by CUDA events;
7. hold the warp kernel against its plain version on the operands HA
   gives it (image warp and probability unwarp, bf16 and int8), and the
   int8 kernels on the shapes route (b) gives them, with times (around
   the call and the device time alone), bounds and ``F.grid_sample`` as
   the warp's yardstick;
8. run HA on 2 images of 64 x 80 by the int8 route on the card and on
   the CPU plain path (same weights, scales and homographies): heatmaps
   within 1e-6, keypoint sets equal;
9. train the full-width SuperPoint of ``spnerf_tpu_torch/configs/
   superpoint_coco_train.yaml`` (240 x 320, batch 2, photometric and
   pair-homography augmentation on the card, blockwise descriptor loss)
   with ``tasks.train_task.train`` for 20 steps on synthetic images with
   256 seeded keypoints each, from seeded weights, with the launch
   counters at 0 before; then validation of 2 batches and a checkpoint,
   and one more step resumed from that checkpoint. The loss must be
   finite and fall, and the three descriptor-loss kernels must have
   launched once per step (the forward once more per validation batch);
   print steps/s and one step split into its parts by CUDA events;
10. hold the three descriptor-loss kernels against their plain version
   on the operands the training step gives them (B 2, N 1,200, C 256)
   and at N 4,800 (480 x 640): sums within 1e-5, gradients within 1e-4
   of their largest entry outside the few rows where a dot lies within
   rounding of a margin, two runs bit-equal; times around the call and on
   the device, the float32 and TF32 bounds, the share of pairs the
   gradients' band summed again in float64 (the kernels' counter), and
   the dense ``descriptor_loss_from_cells`` with autograd as a yardstick;
11. take two steps of a small SuperPoint on the card and on the CPU
   plain path from the same state, draws and batch: augmented images,
   losses and parameters within the stated tolerances;
11a. ``[dist]``, data parallelism, by ``spnerf_tpu_torch/tools/
   smoke_dist.py`` (its docstring has the jobs): two rank processes on
   this card joined by gloo (NCCL takes one rank per card) export HA
   labels of 16 images at 240 x 320 with ``export.serving=int8`` sharded
   by the mesh, export again through ``cli.main`` with ``data.shard:
   auto``, train one step of superpoint_coco_train.yaml through
   ``train()`` and take one ``train_step`` (and 3 timed ones); every
   file byte-equal to this process's export, the step within
   ``smoke_dist.compare_steps``' bounds of this process's, the ranks'
   models bit-equal, rank 0 alone writing; one rank in an NCCL group
   takes the step bit-equal to the step without a group; rows 1-4, 9,
   10 and 11 launched in the ranks (``dist_launches`` in the kernel
   rows); ms per sharded HA batch and per DP step;
11b. NeRF pairs, on two procedural scenes (``box_room``: the inside of a
   box room whose walls carry seeded rectangles, exact along-ray depth
   and gray values per pixel, cameras on an arc; written by
   ``tasks.nerf_task.write_scene`` at 480 x 640, fov 44, 16 training and
   4 validation frames each): ``warp_points_nerf`` on the card against
   the analytic projection of 4,096 seeded pixels per scene away from
   depth edges (within 0.05 px); the label export of
   ``magicpoint_NeRF_export.yaml`` from the demo MagicPoint over both
   scenes and splits (frames/s, labels per frame, fused labels that
   reproject onto the next frame's within 2 px) and one batch split into
   forward, NMS + top-k, fusion + NMS, host writes; 20 steps of
   ``superpoint_NeRF_train.yaml`` through ``train(..., nerf_loss=True,
   train_nerf=True)`` on those labels (NERF_CUTS: the two scenes, 2
   validation batches, one checkpoint, the demo MagicPoint restored in
   part) with the launch counters at 0 before, steps/s and one step
   split; rows 10-11 against their plain version (as in 10) on the last
   NeRF step's operands and on the same with 64 non-finite and 64
   far-off warped cells a sample, their rows carrying the NeRF path's
   launches (``"path": "nerf-train"``); one NeRF step and one fused frame
   at 2 x 64 x 80 on the card against the CPU plain path;
11b'. ``[cli]``, the task CLI (``spnerf_tpu_torch/cli.py``) as a user
   runs it: the 11 configs of ``spnerf_tpu_torch/configs`` read by the
   port's own YAML reader (the card's machine has no ``yaml``); 4
   synthetic HPatches-layout sequences (2 ``i_``, 2 ``v_``, 1.ppm-6.ppm
   and H_1_i from seeded homographies) under the data root;
   ``python3 -m spnerf_tpu_torch.cli --task export_HPatches_Repeatability``
   in a child process and ``cli.main`` with ``--task
   export_HPatches_Descriptors`` (at 120 x 160), both scored by
   ``eval.detector`` / ``eval.descriptor``, and ``eval.on_the_fly.main``
   in both modes over the same sequences (pairs/s, the metrics and their
   95% intervals); ``--task export_NeRF_labels`` for both box rooms and
   splits (labels equal to the NeRF export phase's) and ``--task train
   --train-nerf --nerf-loss --validate-training`` on them with NERF_CUTS,
   the launch counters at 0 before: rows 10-11 once per step (the
   forward once more per validation batch), the loss finite and falling,
   steps/s; a ``profile:`` window of 5 steps leaving a Chrome trace with
   rows 10-11 in it; ``ops.native_nms.exact_nms`` (g++-built from the
   port's own source) against ``ops.nms.box_nms_greedy``;
11c. the NeRF scene pipeline, on no kernel: ``train_nerf_scene`` at the
   classic NeRF's full width (``NeRFConfig()``, float32) on the first box
   room's 16 training frames at 480 x 640 for as many steps of 1,024 rays
   as fit 40 s (``[nerf-scene]``: ms per step, rays/s against the float32
   bound, the loss history, which must fall, and one step split by CUDA
   events); ``render_dataset`` of its 4 validation poses (``[nerf-render]``:
   ms per frame, the rendered depth against the exact depth beside the
   untrained field's, which it must beat, and the demo MagicPoint's
   labels of the rendered frames through ``export_nerf_labels``);
   ``tools.process_scene.main`` on the frames as RGB PNGs with a
   ``transforms.json`` (``[process-scene]``, the tiny preset, read back by
   ``NeRFDataset``); ``HashNeRF`` at ``HashNeRFConfig()`` (``[hash-nerf]``:
   a render of 65,536 rays, 50 Adam steps whose loss must fall); and the
   full-width field and the hash field on the card against the CPU
   (``[nerf-scene-small]``);
11d. ``[pose]``, the relative-pose evaluation (``eval/pose.py``, no
   kernel): one box room (its own seed, 14 frames of 480 x 640) written
   as PNGs with a SuperGlue-format pair list (gaps of 2-5 frames drawn
   with seed 7, and three pairs again with quarter-turns: 16 pairs);
   ``python3 -m spnerf_tpu_torch.eval.pose`` at
   ``pose_estimation_indoor.yaml`` (the demo MagicPoint, a seed-0
   descriptor head, top_k 1,024) in a child process (pairs/s, AUC@5/10/20,
   precision and matching score with their 95% intervals) and
   ``estimate_pose_errors`` again in this process (results equal to the
   child's); one pair split into
   inference and sampling on the card (CUDA events), matching and RANSAC
   + ``recover_pose`` on the host, beside the dense x8 upsample the path
   never reads; ``find_essential_mat`` + ``recover_pose`` on matches from
   the room's exact depth (within 2 deg of the true poses) and with 0.5
   px noise and 30% outliers (each pair's support at least 0.85 of the
   true E's, its errors those of the CPU run); 2 pairs at 120 x 160 on the card
   against the CPU (within 1e-5, matches equal but for near-ties).
   ``[quant]``: ``QuantizedSuperPoint`` from the full-width seeded
   SuperPoint, calibrated on 8 synthetic 480 x 640 images: ms a batch of
   8 and the im2col's share, the logit error against the BN-folded
   float32 model (under 0.1 of the range); at 2 x 64 x 80 the card's
   int32 sums equal to the CPU's, the heads within 1 bf16 ulp;
11e. README's bootstrap from its own data, every task through
   ``cli.main --device cuda``, by ``spnerf_tpu_torch/tools/smoke_data.py``
   (its docstring lists the phases): ``[jpeg]`` every committed JPEG
   fixture read gray and colour to cv2's digests and ms per 480 x 640
   image, baseline and progressive; ``[process-scene-jpeg]``
   ``tools.process_scene`` over the colour fixtures as frames;
   ``[syn-gen]`` / ``[syn-train]`` magicpoint_syn.yaml's Synthetic Shapes
   and 20 steps on them; ``[coco-export]`` HA labels over COCO-layout
   copies of the fixtures (as written and ``export.serving=int8``);
   ``[label-iou]`` the int8 labels' agreement with the bf16 ones and
   ``[ha-rate]`` both exports' images/s by the labels' mtimes (the demo's
   tools, host work); ``[coco-train]`` MagicPoint and SuperPoint (photometric on the card,
   and on the host) at ``data.num_workers`` 1 and 4, the training batch
   indices equal. The kernel rows carry these launches as
   ``coco_export_launches`` (rows 1-4, 9) and ``coco_train_launches``
   (rows 10-11);
11f. ``[demo]``: the repo's end-to-end experiment, ``demo/run_demo.sh``'s
   default chain through ``spnerf_tpu_torch.demo.run`` on the card, in a
   child process (``spnerf_tpu_torch/tools/smoke_demo.py``, whose
   docstring has the cuts): every leg in order, its seconds and
   launches; the fabricated files equal to
   ``spnerf_tpu_torch/demo/digests.json``; the
   warp (row 9) launched in ``ctl_export``, rows 10-11 in ``nerf_sp`` and
   ``ctl_sp``; the pose leg's SIFT calibration row (``baseline/sift``,
   OpenCV's SIFT in the port's host C++, ``native/cv_sift.cpp``) beside
   both arms' rows; the bf16 NeRF step's and frame's ms, the pose AUC of
   both arms and of SIFT, SIFT's host ms an image and the HPatches rows
   printed; then, over the chain's tree, ``[orb]`` the ORB row
   (``baseline/orb``, OpenCV's ORB in ``native/cv_orb.cpp``) beside SIFT's
   and ORB's host ms an image, ``[label-fidelity]`` the NeRF-depth labels
   against ray-traced depth's per scene, ``[live-steps]`` the legs'
   steps/s from their logs, ``[multiproc-export]`` two gloo ranks on the
   card against one process over the 24 COCO stand-ins (labels equal, or
   the phase fails); no kernel lies on these tools' paths. The kernel rows
   carry the launches as ``demo_launches`` ({leg: count});
12. render the committed tiny NeRF sphere fields
   (``benchmarks/data/sphere_field*.npz``, bf16 weights) as
   ``bench_nerf.py`` does: 131,072 rays of an orbit camera (362 x 362
   pixels, padded), 32 samples, near 2, far 6. Build the integral
   occupancy volume once, then with the launch counters at 0 render 10
   times by every variant: dense, early stop, occupancy flags (built inside
   the timed region) + early stop through ``render_fused_rays`` (block
   1,024, chunks of 16 samples), cached flags + early stop through
   ``render_fused``, the width-64 and width-32 fields through
   ``render_fused_rays_packed`` (blocks 512 and 2,048, 16 and 8 packed
   rows), and ``render_fused_int8`` with early stop after
   ``quantize_field`` on the first 4,096 rays. One launch per render,
   finite outputs, depth in [0, far]; print rays/s;
13. render 65,536 held-out rays of the analytic sphere scene (unit sphere
   coloured by its normal, cameras on a shell of radius 4) through each
   kernel and its plain version: every float kernel reaches 38.5 dB and
   lies within 0.3 dB of its plain version, occupancy skipping within 0.3
   dB of dense, int8 within 0.3 dB of its plain version;
14. hold each render kernel against its plain version on the operands the
   drive gives it: rgb and depth within the stated tolerances, two runs
   bit-equal; times around the call and on the device, the bound, and the
   three products alone through ``torch.matmul`` in bf16 as a yardstick;
15. render a few hundred rays on the card and by the plain path on the
   CPU, same weights and flags, at every width and operand type;
16. ``[probes]`` (``spnerf_tpu_torch/tools/smoke_probes.py``; run after
   the serving phases, its rows last in the kernels line): the H100
   probes P1-P4 of the TPU files under ``benchmarks/`` at those files'
   shapes (the 9-tap conv probe in both tap orders, int8 and bf16, C 64 to
   256; the dependent chain of 32 products, int8 and bf16; the three
   gathers at the file's sizes and at a 2^18 x 128 table), the launch
   counters at 0 before; then each kernel instance against its plain
   version (int8 and the gathers bit-equal, bf16 within the bounds that
   module states), a second launch bit-equal, at the module's check
   shapes (the conv's ragged and many-item shapes; the chain at 64, 200
   and 8,256 rows, depths 1-3 and 32; the column gather at ragged widths
   and N != T), then one row per instance with ms, device ms, the plain
   version's and the library call's ms and the bound.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from spnerf_tpu_torch import cli, settings
from spnerf_tpu_torch.data.loader import DataLoader, collate
from spnerf_tpu_torch.data import pnm
from spnerf_tpu_torch.data.nerf_dataset import NeRFDataset, camera_intrinsics
from spnerf_tpu_torch.data.png import write_gray, write_rgb
from spnerf_tpu_torch.eval import descriptor as eval_descriptor
from spnerf_tpu_torch.eval import detector as eval_detector
from spnerf_tpu_torch.eval import on_the_fly
from spnerf_tpu_torch.eval import pose as eval_pose
from spnerf_tpu_torch.eval.essential import find_essential_mat, sampson_errors
from spnerf_tpu_torch.geometry.homography import (
    HomographyConfig,
    sample_homographies,
    warp_points,
)
from spnerf_tpu_torch.geometry.reprojection import warp_points_nerf
from spnerf_tpu_torch.kernels import _build
from spnerf_tpu_torch.kernels import conv_stack
from spnerf_tpu_torch.kernels import desc_sample as ds
from spnerf_tpu_torch.kernels import descriptor_loss as dl
from spnerf_tpu_torch.kernels import render as rk
from spnerf_tpu_torch.kernels import tail_fused
from spnerf_tpu_torch.kernels import conv12_fused as c12
from spnerf_tpu_torch.kernels import mid_fused
from spnerf_tpu_torch.kernels.conv12_fused import conv12_fused_plain
from spnerf_tpu_torch.kernels.mid_fused import double_conv3x3_plain
from spnerf_tpu_torch.kernels.tail_fused import head_plain
from spnerf_tpu_torch.kernels.warp import (
    invert_homographies,
    source_coords,
    warp_by_inverse,
    warp_by_inverse_plain,
)
from spnerf_tpu_torch.models.fused_tiny_nerf import (
    direction_features,
    encode_rays,
    render_fused_rays,
    render_fused_rays_packed,
)
from spnerf_tpu_torch.models.hash_nerf import (
    HashNeRF,
    HashNeRFConfig,
    init_hash_nerf,
    render_rays_hash,
)
from spnerf_tpu_torch.models.nerf import (
    NeRF,
    NeRFConfig,
    composite,
    draw_ray_uniforms,
    encode_ray_points,
    init_nerf,
    positional_encoding,
    render_image,
    render_rays,
    render_weights,
    sample_pdf,
    stratified_samples,
)
from spnerf_tpu_torch.models.superpoint import (
    SuperPointConfig,
    fold_batch_norm,
    folded_superpoint,
    init_superpoint,
    superpoint_inference,
)
from spnerf_tpu_torch.ops import homography_adaptation as ha_mod
from spnerf_tpu_torch.ops import native_nms
from spnerf_tpu_torch.ops import quantization
from spnerf_tpu_torch.ops import serving
from spnerf_tpu_torch.ops.fast_inference import (
    _cell_candidates,
    build_inference,
    detect_from_logits,
    detect_from_probs_padded,
    make_infer,
    sample_descriptors_onehot,
)
from spnerf_tpu_torch.ops.homography_adaptation import (
    HAConfig,
    homography_adaptation,
    image_homographies,
)
from spnerf_tpu_torch.ops.image_warp import (
    valid_mask_from_inverse,
    warp_image,
)
from spnerf_tpu_torch.ops.descriptor_sampling import sample_descriptors
from spnerf_tpu_torch.ops.nerf_label_fusion import fuse_nerf_labels
from spnerf_tpu_torch.ops.nms import box_nms, box_nms_greedy
from spnerf_tpu_torch.ops.occupancy import chunk_flags, field_integral_volume
from spnerf_tpu_torch.ops.photometric_device import (
    draw_photometric_randoms,
    photometric_from_draws,
)
from spnerf_tpu_torch.ops.upsample import upsample_bicubic
from spnerf_tpu_torch.tasks import export, export_nerf, train_task
from spnerf_tpu_torch.tasks.nerf_task import (
    create_nerf_optimizer,
    nerf_train_step,
    nerf_train_steps,
    pose_orbit,
    render_dataset,
    scene_rays,
    train_nerf_scene,
    write_scene,
)
from spnerf_tpu_torch.tools import (process_scene, smoke_data, smoke_demo,
                                    smoke_dist, smoke_probes)
from spnerf_tpu_torch.tools.smoke_data import (
    check_labels,
    cut as _cut,
    log,
    read_metrics,
    set_args,
)
from spnerf_tpu_torch.tools.kernel_times import (
    HINGE_SHAPES,
    RENDER_FIELDS,
    device_ms,
    hinge_operands,
    load_field,
    orbit_rays,
    plant_bad_cells,
)
from spnerf_tpu_torch.train import loop
from spnerf_tpu_torch.train.losses import (
    DescriptorLossConfig,
    cell_grid_coords,
    descriptor_loss_from_cells,
    detector_loss,
    detector_noise,
)
from spnerf_tpu_torch.train.pipeline import (
    prepare_nerf_batch,
    prepare_superpoint_batch,
)
from spnerf_tpu_torch.utils.config import apply_overrides, load_config
from spnerf_tpu_torch.utils.factories import get_nerf_loaders

H, W = 480, 640
BATCH = 64
REQUESTS = 5
TOP_K = 1024
SEED = 0

# (dense int8 operations/s, memory bytes/s, float32 operations/s outside
# the tensor cores, dense bf16 tensor-core operations/s) from NVIDIA's
# data sheets; the first name found in the card's name applies
PEAKS = {
    "H100 PCIe": (1513e12, 2.0e12, 51.2e12, 756e12),
    "H100 NVL": (1671e12, 3.9e12, 60e12, 835e12),
    "H100": (1979e12, 3.35e12, 67e12, 989e12),
    "H200": (1979e12, 4.8e12, 67e12, 989e12),
}

# the configurations, read by the port's own YAML reader from its copies
# of the configs
CONFIGS = Path(__file__).resolve().parent / "spnerf_tpu_torch" / "configs"
# magicpoint_coco_export.yaml; the export reads its data.experiment_name,
# data.batch_size, homography_adaptation and model.detector_head, and
# adds export.serving per route; the model is seeded (ha_model), so its
# pretrained is not read
EXPORT_CONFIG = load_config(CONFIGS / "magicpoint_coco_export.yaml")
HA_H, HA_W = 240, 320
HA_IMAGES = 20  # batches of 8, 8 and a padded 4
# gain on the seeded detector's last conv: a random MagicPoint's
# probabilities all sit within 1e-3 of 1/65, right at det_thresh; the gain
# spreads them as a trained detector's are spread
DET_GAIN = 10.0
# float operations per output pixel of csrc/warp.cu (bf16 mode): source
# coordinates 14, four hat weights 16, roundings 6, taps and sums 10
WARP_FLOPS_PER_PIXEL = 46
# card against CPU: the same inverse bits and int8 kernels; the logits'
# softmax (expf) may differ by float32 ulps (measured 5.6e-9)
HA_SMALL_TOL = 1e-6

# superpoint_coco_train.yaml, with the cuts of TRAIN_CUTS applied by
# train_config()
TRAIN_CONFIG = load_config(CONFIGS / "superpoint_coco_train.yaml")
# what the smoke run changes in that file: 20 steps, then validation of 2
# batches and a checkpoint; seeded weights (no MagicPoint checkpoint is in
# the repository); the loss read from the card every 5 steps. The data
# are cut too: synthetic images with 256 seeded keypoints each in place
# of COCO and its exported labels.
TRAIN_CUTS = {"train.num_iters": 20, "save_or_validation_interval": 20,
              "pretrained": None, "train.val_batches": 2, "log_every": 5}
TRAIN_H, TRAIN_W = 240, 320
DEV = "cuda"  # the training phases' device
TRAIN_KPTS = 256
# kernel against plain version: the sums are float32 sums over N x N pairs
# in another order; a gradient row differs only where a dot lies within
# float32 rounding of a margin and takes the other side of the step
DESC_SUM_RTOL = 1e-5
DESC_GRAD_TOL = 1e-4  # of the gradient's largest entry
DESC_FLIPPED_ROWS = 1e-3  # share of rows allowed beyond DESC_GRAD_TOL
# float operations per cell pair besides the 2 * C of the dot: distance 5,
# hinge and weights 8 (forward); step and weights 4 (backward)
DESC_PAIR_FLOPS_FWD, DESC_PAIR_FLOPS_BWD = 13, 9
# card against CPU over two small steps: float32 convs (no TF32) and sums
# in another order; see phase_train_small
SMALL_LOSS_RTOL = 2e-4
SMALL_IMAGE_ATOL = 1e-5

# the tiny NeRF sphere fields as bench_nerf.py renders them
# (kernel_times.RENDER_FIELDS: width -> file, block, s_chunk); an orbit
# camera of 362 x 362 pixels padded to 131,072 rays, 32 samples, bf16
# weights, 10 renders per variant
RENDER_RAYS = 131072
RENDER_ITERS = 10
RENDER_EPS = 1e-3
INT8_CALIB_RAYS = 4096
RENDER_SOURCE = "spnerf_tpu_torch/kernels/csrc/render.cu"
RENDER_REPLACES = {
    "render[bf16]": "spnerf_tpu/kernels/render_pallas.py:150",
    "render[int8]": "spnerf_tpu/kernels/render_pallas.py:425",
    "render[w64]": "spnerf_tpu/kernels/render_pallas.py:726",
    "render[w32]": "spnerf_tpu/kernels/render_pallas.py:726",
    "render[f32]": "spnerf_tpu/kernels/render_pallas.py:150",
    "render[f32-w64]": "spnerf_tpu/kernels/render_pallas.py:726",
    "render[f32-w32]": "spnerf_tpu/kernels/render_pallas.py:726"}
# kernel against plain version on the card: the same roundings and skips;
# where the library's dots sum in another order, a sum on the other side of
# a bf16 rounding moves one hidden activation by one ulp, which through the
# committed fields moves rgb by up to 8e-4, so the bf16 kernel sums again
# in the library's order (FMAs in k order) wherever the order could decide
# a rounding (measured on an H100: equal at these shapes but for the dense
# head's last ulps)
RENDER_RGB_TOL = 1e-4
RENDER_DEPTH_TOL = 1e-3
# the float32 render (split TF32 on the tensor cores) against the plain
# version's cuBLAS float32 products, as tests/test_torch_cuda.py holds it:
# the sums a few float32 ulps apart, nothing rounded between the products
RENDER_F32_TOL = (2e-5, 1e-4)
# held-out rays of the analytic sphere: the reference package's renderer
# gives 39.2-39.8 dB on such rays on the CPU
QUALITY_RAYS = 65536
QUALITY_MIN_DB = 38.5
QUALITY_GAP_DB = 0.3
# card against the CPU plain path on a few hundred rays, (rgb, depth): the
# two libraries' sines, exponentials and dot orders differ in the last bit
# (measured 3.0e-7, 9.5e-7), which a bf16 or int8 rounding can turn into
# one step of a hidden activation (measured 1.6e-5, 2.8e-5 with bf16)
SMALL_RENDER_TOL = {"f32": (5e-6, 2e-5), "bf16": (2e-4, 5e-4),
                    "int8": (5e-4, 2e-3)}

# row 8, the fused bicubic sampler, on the slice's sampling operands
DESC_SOURCE = "spnerf_tpu_torch/kernels/csrc/desc_sample.cu"
DESC_REPLACES = "spnerf_tpu/kernels/desc_sample_pallas.py:96"
DESC_MICRO_K = 1000  # benchmarks/micro_desc_sample.py's K
# kernel against plain version on unit vectors: the same products summed
# in the same order, the sum of squares in another; against the request's
# one-hot output: the same products summed in the product's order
DESC_PLAIN_TOL, DESC_ONEHOT_TOL = 1e-6, 2e-6

HP_CONFIGS = {
    "repeatability": load_config(CONFIGS / "magicpoint_repeatability.yaml"),
    "descriptors": load_config(CONFIGS / "superpoint_descriptors.yaml")}
# cuts: the repository's only checkpoint (a MagicPoint the JAX package
# trained, under demo/) in place of both configs' own, and synthetic
# pairs; the dense 480 x 640 x 256 float32 descriptors make each bundle
# 629 MB that np.savez_compressed writes on one host core (~35 s a pair),
# so one descriptor pair, to leave the script's time to [demo]
HP_CUTS = {"pretrained": "pretrained/demo_mp_5000.ckpt"}
HP_PAIRS = {"repeatability": 16, "descriptors": 1}
HP_HOMOGRAPHY = EXPORT_CONFIG["homography_adaptation"]["params"]
# card against CPU, float32 with TF32 off: sums in other orders
HP_SMALL_TOL = 1e-5

# serving-module name of each wrapper -> (plain version, CUDA source,
# TPU kernel it replaces); the bf16 instances of double_conv3x3 and head
# share the int8 rows' sources
WRAPPERS = {
    "conv12_fused": (conv12_fused_plain,
                     "spnerf_tpu_torch/kernels/csrc/conv12_fused.cu",
                     "spnerf_tpu/kernels/conv12_fused_pallas.py:173"),
    "double_packed_conv3x3": (double_conv3x3_plain,
                              "spnerf_tpu_torch/kernels/csrc/double_conv3x3.cu",
                              "spnerf_tpu/kernels/mid_fused_pallas.py:133"),
    "double_conv3x3": (double_conv3x3_plain,
                       "spnerf_tpu_torch/kernels/csrc/double_conv3x3.cu",
                       "spnerf_tpu/kernels/tail_fused_pallas.py:99"),
    "head": (head_plain, "spnerf_tpu_torch/kernels/csrc/head.cu",
             "spnerf_tpu/kernels/tail_fused_pallas.py:179"),
    "conv3x3": (conv_stack.conv3x3_plain,
                "spnerf_tpu_torch/kernels/csrc/conv3x3.cu",
                "spnerf_tpu/kernels/conv_stack_pallas.py:156"),
    "packed_conv3x3": (conv_stack.conv3x3_plain,
                       "spnerf_tpu_torch/kernels/csrc/conv3x3.cu",
                       "spnerf_tpu/kernels/conv_stack_pallas.py:295"),
    "dot_bias_act": (conv_stack.dot_bias_act_plain,
                     "spnerf_tpu_torch/kernels/csrc/dot_bias_act.cu",
                     "spnerf_tpu/kernels/conv_stack_pallas.py:381"),
}
# kernels that round a mid activation to bf16 before their last sum
CHAINS = ("double_packed_conv3x3", "double_conv3x3", "head")
# wrapper -> what its kernels' symbols hold (the device time of a call
# counts these, apart from the padding and packing launches of a call on
# raw weights)
KERNEL_SYMBOLS = {"conv12_fused": "::conv12_", "double_packed_conv3x3":
                  "::double_conv3x3_", "double_conv3x3": "::double_conv3x3_",
                  "head": "::head_", "conv3x3": "::conv3x3_",
                  "packed_conv3x3": "::conv3x3_", "dot_bias_act": "::dot_"}
# kernel against plain version, bf16 or float32 operands: within 2 bf16
# ulps, at most 0.1% of the values beyond 1 (float32 sums in a fixed
# order, by FMAs or on the tensor cores, against float64 sums rounded
# once). Ulps are counted at the larger of
# the two values and at least at a floor of the tensor's largest
# magnitude: 1/256 (below it a bf16 ulp is finer than a float32 sum's own
# rounding), 1/4 for the chains (a mid value rounded apart moves every
# output it feeds by the weight times its ulp, an error on the scale of
# the largest outputs: 4 ulps at a 1/16 floor in 1.3e-5 of the values of
# head[bf16-256] at batch 64 on an H100)
BF16_FLOOR, BF16_CHAIN_FLOOR = 2.0 ** -8, 2.0 ** -2
BF16_MAX_ULPS, BF16_SHARE_OVER_1 = 2, 1e-3


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"chip_smoke: no data-sheet peaks for {name!r}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def raw_args(args) -> tuple:
    """A call's arguments with prepared operands (``DotOperands``,
    ``ConvOperands``, ``HeadOperands``, ``Conv12Operands``,
    ``DoubleConvOperands``) expanded into their raw tensors."""
    out = []
    for a in args:
        if isinstance(a, (conv_stack.DotOperands, conv_stack.ConvOperands)):
            out += [a.w, a.mult, a.bias]
        elif isinstance(a, (tail_fused.HeadOperands, c12.Conv12Operands,
                            mid_fused.DoubleConvOperands)):
            out += list(a.raw)
        else:
            out.append(a)
    return tuple(out)


def work(name, args, kw, out):
    """(multiply-accumulates, bytes read once + written once) of one
    kernel call, from its operands' shapes."""
    if name in ("conv3x3", "packed_conv3x3"):
        x, w = args[:2]
        B, h, w_, cin = x.shape
        macs = B * h * w_ * 9 * cin * w.shape[-1]
    elif name == "dot_bias_act":
        x, w = args[:2]
        macs = x.numel() * w.shape[-1]
    elif name == "conv12_fused":
        image, k1, _, _, w2 = args[:5]
        B, h, w, _ = image.shape
        macs = B * h * w * 9 * (1 + 64) * 64
    elif name in ("double_packed_conv3x3", "double_conv3x3"):
        x, w_a, _, _, w_b = args[:5]
        B, h, w, cin = x.shape
        macs = B * h * w * 9 * (cin * w_a.shape[-1]
                                + w_a.shape[-1] * w_b.shape[-1])
    else:  # head
        x, w3, _, _, w1 = args[:5]
        B, h, w, cin = x.shape
        macs = B * h * w * (9 * cin * w3.shape[-1] + w1.numel())
    return macs, nbytes(*args, out)


@contextlib.contextmanager
def recorded_calls(calls: list):
    """Record (wrapper name, args, kwargs) of every kernel call the
    serving graph makes (``conv1_packed`` calls ``dot_bias_act`` in
    ``conv_stack``)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in
             [(serving, n) for n in WRAPPERS] + [(conv_stack, "dot_bias_act")]]

    def recorder(name, fn):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return call

    for mod, name, fn in saved:
        setattr(mod, name, recorder(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits >= 0, bits, -(bits & 0x7FFF))
    return int((ordered(a) - ordered(b)).abs().max())


def bf16_scaled_ulps(got, want, floor):
    """Per-value distance in bf16 ulps at the larger of the two values,
    and at least at ``floor`` times ``want``'s largest magnitude."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    mag = torch.clamp_min(mag, max(floor * float(w.abs().max()), 1e-30))
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def compare(name, got, want, float_operands=False, chain=False):
    """(max |got - want|, share of values that differ, share beyond 1 bf16
    ulp); raises unless int8 results are equal, bf16 results of int8 sums
    within 1 ulp, and bf16 results of bf16 or float32 operands within
    BF16_MAX_ULPS with at most BF16_SHARE_OVER_1 beyond 1."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    err = float((got.float() - want.float()).abs().max())
    over_1 = 0.0
    if got.dtype == torch.int8 and err != 0:
        n = int((got != want).sum())
        raise AssertionError(f"{name}: {n} int8 values differ (max {err})")
    if got.dtype == torch.bfloat16 and not float_operands \
            and bf16_ulps(got, want) > 1:
        raise AssertionError(f"{name}: bf16 differs by "
                             f"{bf16_ulps(got, want)} ulps")
    if got.dtype == torch.bfloat16 and float_operands:
        d = bf16_scaled_ulps(got, want,
                             BF16_CHAIN_FLOOR if chain else BF16_FLOOR)
        over_1 = float((d > 1).float().mean())
        if float(d.max()) > BF16_MAX_ULPS or over_1 > BF16_SHARE_OVER_1:
            raise AssertionError(f"{name}: bf16 differs by {float(d.max())} "
                                 f"ulps, {over_1:.3e} of values beyond 1")
    return err, float((got != want).float().mean()), over_1


def library_call(name, args, kw):
    """One PyTorch call computing the kernel's function on the same
    inputs (without its ReLU, pool or cast), or None where there is none:
    cuDNN convs in bf16 (channels-last), addmm in bf16 or float32,
    ``torch._int_mm`` for an int8 product."""
    x = args[0]
    if name == "conv12_fused" or (x.dtype == torch.int8
                                  and name != "dot_bias_act"):
        return None  # int8 convs: F.conv2d takes no int8 CUDA tensors

    def conv(inp, w, b):
        w = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        return F.conv2d(inp, w, b.to(w.dtype), padding=w.shape[-1] // 2)

    if name in ("conv3x3", "packed_conv3x3"):
        xc = x.permute(0, 3, 1, 2)
        return lambda: conv(xc, args[1], args[3])
    if name in ("double_packed_conv3x3", "double_conv3x3"):
        xc = x.permute(0, 3, 1, 2)
        return lambda: conv(conv(xc, args[1], args[3]), args[4], args[6])
    if name == "head":
        xc, w1 = x.permute(0, 3, 1, 2), args[4][None, None]
        return lambda: conv(conv(xc, args[1], args[3]), w1, args[6])
    x2, w = x.reshape(-1, x.shape[-1]), args[1]
    if x.dtype == torch.int8:
        n = -(-w.shape[-1] // 8) * 8  # _int_mm takes widths of 8
        wc = F.pad(w, (0, n - w.shape[-1])).t().contiguous().t()
        return lambda: torch._int_mm(x2, wc)
    b = args[3].to(x.dtype)
    return lambda: torch.addmm(b, x2, w)


def synthetic_images(n: int, gen: torch.Generator,
                     size=(H, W)) -> torch.Tensor:
    """(n, H, W, 1) float32 in [0, 1] on the card: smooth blobs from
    upsampled coarse noise plus fine grain, so that the backbone sees
    edges and corners rather than white noise."""
    h, w = size
    coarse = torch.rand((n, 1, h // 16, w // 16), generator=gen, device="cuda")
    img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                        align_corners=False)
    img = img + 0.05 * torch.rand((n, 1, h, w), generator=gen, device="cuda")
    return img.clamp(0, 1).permute(0, 2, 3, 1).contiguous()


def phase_build():
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(reports)} CUDA sources built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if ("Compiling entry" in line or "Used" in line or "spill" in line
                    or "arning" in line):
                log(f"[build] {name}: {line.strip()}")


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(out, flush=True)
    return out


def phase_kernels(calls, peaks):
    """Each recorded call (the first of each kernel instance): kernel
    against plain version on the same operands, with times, the bound and
    the library yardstick. ``ms`` and ``library_ms`` are CUDA events
    around one call (the wrapper's host work included); ``device_ms`` and
    ``library_device_ms`` the device time alone (``torch.profiler`` over
    20 calls: the kernel's own symbol, every kernel of the library
    call)."""
    int8_rate, mem_rate, f32_rate, bf16_rate = peaks
    rows, seen = [], set()
    for name, args, kw in calls:
        plain, source, replaces = WRAPPERS[name]
        kernel = getattr(serving, name)
        before = _build.launch_counts.copy()
        got = kernel(*args, **kw)
        key, = (_build.launch_counts - before).keys()
        if key in seen:  # the same instance at the same shapes
            del got
            continue
        seen.add(key)
        want = plain(*args, **kw)
        dtype = args[0].dtype if name != "conv12_fused" else torch.int8
        err, share, over_1 = compare(key, got, want,
                                     float_operands=dtype != torch.int8,
                                     chain=name in CHAINS)
        ms = cuda_ms(lambda: kernel(*args, **kw), reps=20, warmup=3)
        dev_ms, how = device_ms(lambda: kernel(*args, **kw),
                                KERNEL_SYMBOLS[name])
        plain_ms = cuda_ms(lambda: plain(*args, **kw), reps=3)
        rargs = raw_args(args)
        lib = library_call(name, rargs, kw)
        lib_ms = lib_dev_ms = None
        if lib is not None:
            lib_ms = cuda_ms(lib, reps=20, warmup=3)
            lib_dev_ms = device_ms(lib)[0]
        macs, moved = work(name, rargs, kw, got)
        rate = {torch.int8: int8_rate, torch.bfloat16: bf16_rate,
                torch.float32: f32_rate}[dtype]
        t_ops, t_bytes = 2 * macs / rate * 1e3, moved / mem_rate * 1e3
        rows.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms,
        })
        lib_text = ("none" if lib_ms is None else
                    f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f})")
        log(f"[kernel] {key}: in {tuple(args[0].shape)} {dtype} -> out "
            f"{tuple(got.shape)} {got.dtype}, max_abs_err {err} "
            f"({share:.3e} of values differ, {over_1:.3e} beyond 1 bf16 "
            f"ulp), kernel {ms:.4f} ms (median of 20; device {dev_ms:.4f} "
            f"ms by {how}), plain {plain_ms:.4f} ms, library {lib_text}, "
            f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}, "
            f"{2 * macs / 1e9:.2f} GOP, {moved / 1e6:.1f} MB)")
        del got, want, lib
        torch.cuda.empty_cache()
    return rows


def check_outputs(pts, scores, valid, desc, batch=BATCH):
    expect = {"pts": (batch, TOP_K, 2), "scores": (batch, TOP_K),
              "valid": (batch, TOP_K), "desc": (batch, TOP_K, 256)}
    for key, t in zip(expect, (pts, scores, valid, desc)):
        if tuple(t.shape) != expect[key]:
            raise AssertionError(f"{key}: shape {tuple(t.shape)}")
    if not (torch.isfinite(pts).all() and torch.isfinite(scores).all()
            and torch.isfinite(desc).all()):
        raise AssertionError("non-finite outputs")
    if not valid.any(dim=1).all():
        raise AssertionError("an image has no valid keypoint")
    norms = desc[valid].norm(dim=-1)
    if float((norms - 1).abs().max()) > 1e-3:
        raise AssertionError("descriptors at valid points are not unit norm")


def phase_split(infer, images, cfg):
    """Device time of the serving graph and of detection + sampling, one
    request each, apart."""
    out = infer.serving(images, softmax=True)

    def post():
        pts, _, _ = detect_from_probs_padded(
            out["probs"], cfg.grid_size, min_prob=cfg.det_thresh,
            size=cfg.nms, top_k=TOP_K, num_candidates=TOP_K, compact=False)
        sample_descriptors_onehot(out["desc_raw"], pts, cfg.grid_size)

    graph_ms = cuda_ms(lambda: infer.serving(images, softmax=True), reps=5)
    post_ms = cuda_ms(post, reps=5)
    log(f"[split] batch {BATCH}: serving graph {graph_ms:.4f} ms, detect + "
        f"descriptor sampling {post_ms:.4f} ms (medians of 5)")


def phase_slice(infer, requests):
    """Answer the requests with every launch counter at 0 before."""
    infer(requests[0])  # warm-up: library handles, allocator pools
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    times, outs = [], None
    t_all = time.perf_counter()
    for images in requests:
        t0 = time.perf_counter()
        outs = infer(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    total = time.perf_counter() - t_all
    counts = dict(_build.launch_counts)
    check_outputs(*outs)
    n_valid = int(outs[2].sum())
    log(f"[slice] {len(requests)} requests of batch {BATCH} at {H}x{W}: "
        f"{total:.4f} s, {len(requests) * BATCH / total:.2f} frames/s; "
        f"per request (s): {', '.join(f'{t:.4f}' for t in times)}; "
        f"median {statistics.median(times) * 1e3:.3f} ms; "
        f"{n_valid} valid keypoints in the last request")
    log(f"[slice] launches: {json.dumps(counts, sort_keys=True)}")
    per_family = {"conv12_fused": 1, "double_conv3x3": 3, "head": 2}
    for family, per_request in per_family.items():
        n = sum(v for k, v in counts.items() if k.startswith(family))
        if n != per_request * len(requests):
            raise AssertionError(f"{family}: {n} launches, expected "
                                 f"{per_request} per request")
    return counts


# the serving routes beside the int8 slice: (label, mode, fused_mid,
# fused_tail, batch, width, requests) -> kernel launches per request
SLICE_W_NARROW = 632  # W % 16 == 8: the fused mid drops to per-layer kernels
SLICE_ROUTES = [
    (("slice-bf16", "bf16", True, True, BATCH, W, REQUESTS), {
        "packed_conv3x3[bf16-64-64-pool]": 1,
        "double_conv3x3[bf16-64-64-64-pool]": 1,
        "double_conv3x3[bf16-64-128-128-pool]": 1,
        "double_conv3x3[bf16-128-128-128]": 1,
        "head[bf16-65-softmax]": 1, "head[bf16-256]": 1}),
    (("slice-mixed", "mixed", True, True, BATCH, W, REQUESTS), {
        "conv12_fused[pool]": 1, "double_conv3x3[64-64-64-pool]": 1,
        "double_conv3x3[64-128-128-pool]": 1, "double_conv3x3[128-128-128]": 1,
        "head[bf16-65-softmax]": 1, "head[bf16-256]": 1}),
    (("slice-unfused", "int8", False, False, 8, W, REQUESTS), {
        "conv12_fused[pool]": 1, "packed_conv3x3[int8-64-64]": 1,
        "packed_conv3x3[int8-64-64-pool]": 1,
        "packed_conv3x3[int8-64-128]": 1, "conv3x3[int8-128-128-pool]": 1,
        "conv3x3[int8-128-128]": 2, "conv3x3[int8-128-256]": 2,
        "dot_bias_act[int8-256-65]": 1, "dot_bias_act[int8-256-256]": 1}),
    (("slice-unfused", "bf16", False, False, 8, W, REQUESTS), {
        "dot_bias_act[f32-9-64-relu]": 1,
        "packed_conv3x3[bf16-64-64-pool]": 2, "packed_conv3x3[bf16-64-64]": 1,
        "packed_conv3x3[bf16-64-128]": 1, "conv3x3[bf16-128-128-pool]": 1,
        "conv3x3[bf16-128-128]": 2, "conv3x3[bf16-128-256]": 2,
        "dot_bias_act[bf16-256-65]": 1, "dot_bias_act[bf16-256-256]": 1}),
    (("slice-unfused", "int8", True, True, 8, SLICE_W_NARROW, 1), {
        "conv12_fused[pool]": 1, "packed_conv3x3[int8-64-64]": 1,
        "packed_conv3x3[int8-64-64-pool]": 1,
        "packed_conv3x3[int8-64-128]": 1, "conv3x3[int8-128-128-pool]": 1,
        "double_conv3x3[128-128-128]": 1, "head[65-softmax]": 1,
        "head[256]": 1}),
]
# card against the CPU plain path on small inputs, as the CPU tests hold
# the port against the JAX package: mixed (int8 backbone, one bf16 head)
# at most 0.1% of values beyond 1 bf16 ulp (floor 1/256) and all within
# 1e-2 of the largest magnitude; bf16 (ten bf16 layers whose roundings
# compound) every value within 1 ulp of the tensor's largest magnitude;
# each keypoint set holds at most 1% of the points, or one point, that
# the other lacks
SMALL_ROUTES = [("bf16", True, True), ("mixed", True, True),
                ("int8", False, False), ("bf16", False, False)]


def phase_route(label, infer, requests, expect):
    """Answer ``requests`` through ``infer`` with every launch counter at 0
    before; check the outputs and that exactly the kernels of ``expect``
    launched, each its count per request."""
    batch, h, w = requests[0].shape[:3]
    infer(requests[0])  # warm-up
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    times, outs = [], None
    t_all = time.perf_counter()
    for images in requests:
        t0 = time.perf_counter()
        outs = infer(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    total = time.perf_counter() - t_all
    counts = dict(_build.launch_counts)
    check_outputs(*outs, batch=batch)
    sp = infer.serving
    log(f"[{label}] mode {sp.mode}, fused_mid {sp.fused_mid}, fused_tail "
        f"{sp.fused_tail}: {len(requests)} requests of batch {batch} at "
        f"{h}x{w}: {total:.4f} s, {len(requests) * batch / total:.2f} "
        f"frames/s; per request (s): {', '.join(f'{t:.4f}' for t in times)}; "
        f"median {statistics.median(times) * 1e3:.3f} ms; "
        f"{int(outs[2].sum())} valid keypoints in the last request")
    log(f"[{label}] launches: {json.dumps(counts, sort_keys=True)}")
    want = {k: n * len(requests) for k, n in expect.items()}
    if counts != want:
        raise AssertionError(f"[{label}] launches {counts}, expected {want}")
    return counts


def phase_route_split(label, infer, images, cfg):
    """Device time of the serving graph and of detection + sampling."""
    sp = infer.serving
    out = sp(images, softmax=sp.fused_tail)

    def post():
        if sp.fused_tail:
            pts, _, _ = detect_from_probs_padded(
                out["probs"], cfg.grid_size, min_prob=cfg.det_thresh,
                size=cfg.nms, top_k=TOP_K, num_candidates=TOP_K,
                compact=False)
        else:
            pts, _, _ = detect_from_logits(
                out["logits"], cfg.grid_size, min_prob=cfg.det_thresh,
                size=cfg.nms, top_k=TOP_K, num_candidates=1024)
        sample_descriptors_onehot(out["desc_raw"], pts, cfg.grid_size)

    graph_ms = cuda_ms(lambda: sp(images, softmax=sp.fused_tail), reps=5)
    post_ms = cuda_ms(post, reps=5)
    log(f"[{label}-split] mode {sp.mode}, batch {images.shape[0]} at "
        f"{images.shape[1]}x{images.shape[2]}: serving graph {graph_ms:.4f} "
        f"ms, detect + descriptor sampling {post_ms:.4f} ms (medians of 5)")


def phase_slice_routes(model, cfg, requests, peaks):
    """Each route of SLICE_ROUTES through ``build_inference``: its kernels
    against their plain versions on one request's operands, then the
    requests with the counters at 0 before, then the split. Returns the
    kernel rows with their launches on the route."""
    rows = []
    for (label, mode, fused_mid, fused_tail, batch, width, n), expect in \
            SLICE_ROUTES:
        reqs = [r[:batch, :, :width].contiguous() for r in requests[:n]]
        infer = build_inference(cfg, model, requests[0][:8], mode=mode,
                                fused_mid=fused_mid, fused_tail=fused_tail,
                                device="cuda", top_k=TOP_K)
        calls = []
        with recorded_calls(calls):
            infer.serving(reqs[0], softmax=fused_tail)
        torch.cuda.synchronize()
        route_rows = phase_kernels(calls, peaks)
        del calls
        counts = phase_route(label, infer, reqs, expect)
        phase_route_split(label, infer, reqs[0], cfg)
        for row in route_rows:
            row["launches"] = counts.get(row["name"], 0)
            if row["launches"] == 0:
                raise AssertionError(f"{row['name']} never launched on the "
                                     f"{label} route")
        rows += route_rows
        del infer, reqs
        torch.cuda.empty_cache()
    return rows


# the tensor-core head (bf16) and dot_bias_act (int8, bf16) instances and
# conv1's float32 instance off the main path's tiles: head at HA's 80 x
# 30 x 40 (H not a multiple of 8) and at 1 x 7 x 13; the products at M
# not a multiple of their 64- or 256-row tiles
REDESIGNED_HEAD_SHAPES = [(80, 30, 40), (1, 7, 13)]
REDESIGNED_DOT_ROWS = [1, 63, 65, 129, 37920]
# conv12 on the int8 tensor cores off the 16 x 32 output tile ((B, H, W),
# pool): odd H and W unpooled, ragged tiles, W 632 of the narrow route;
# the warp at W % 4 in {0, 1, 2, 3} around its 128-column tile, 19 rows
REDESIGNED_CONV12 = [((1, 7, 13), False), ((2, 40, 56), True),
                     ((2, 40, 56), False), ((3, 34, 632), True)]
REDESIGNED_WARP_WIDTHS = [52, 53, 54, 55, 131]
# the int8 double conv and head on the int8 tensor cores off their 16 x
# 16 and 8 x 16 tiles ((B, H, W), pool): odd H and W unpooled, ragged
# tiles pooled; the head also at HA's 80 x 30 x 40 in logits mode
REDESIGNED_S8_DOUBLE = [((1, 7, 13), False), ((2, 30, 40), False),
                        ((2, 30, 40), True), ((3, 34, 62), True)]
REDESIGNED_S8_HEAD_SHAPES = [(80, 30, 40), (1, 7, 13), (3, 34, 62)]
# conv3x3's int8 instance off its 16 x 16 tile ((B, H, W), pool): odd H
# and W unpooled, ragged tiles and W % 16 == 8 pooled and not
REDESIGNED_S8_CONV = [((1, 7, 13), False), ((2, 30, 40), False),
                      ((2, 30, 40), True), ((3, 34, 62), True)]


def phase_redesigned():
    """Each redesigned instance against its plain version (int8 products,
    conv12 and the int8 double convs equal; the int8 heads' logits equal,
    their softmax within 1 bf16 ulp; bf16 by ``compare``'s bounds, the
    head at the chains' floor), on operands prepared once; a call on the
    raw weights and a second launch must give the same bits. Then the warp
    at REDESIGNED_WARP_WIDTHS (N = 3 B, a zero denominator) within 1e-6."""
    rng = np.random.default_rng(SEED + 12)

    def card(a, dtype=None):
        t = torch.from_numpy(np.asarray(a)).cuda()
        return t if dtype is None else t.to(dtype)

    def held(label, wrapper, plain, x, ops, raw, kw, kind):
        got, again = wrapper(x, ops, **kw), wrapper(x, ops, **kw)
        from_raw = wrapper(x, *raw, **kw)
        torch.cuda.synchronize()
        for other in (again, from_raw):
            if not torch.equal(got.view(torch.int8), other.view(torch.int8)):
                raise AssertionError(f"{label}: launches differ in their bits")
        want = plain(x, *raw, **kw)
        if kind == "int8" and not torch.equal(got, want):
            raise AssertionError(f"{label}: int8 product differs from its "
                                 "plain version")
        if got.dtype == torch.int8:
            return f"{label} equal"
        _, share, over_1 = compare(label, got, want,
                                   float_operands=kind != "head-int8",
                                   chain=kind == "head")
        return f"{label} {share:.2e}/{over_1:.2e}"

    notes = []
    for B, h, w in REDESIGNED_HEAD_SHAPES:
        x = card(rng.uniform(0, 1, (B, h, w, 128)).astype(np.float32),
                 torch.bfloat16)
        for cout, soft in ((65, True), (65, False), (256, False)):
            raw = (card(rng.standard_normal((3, 3, 128, 256)).astype(
                       np.float32) / np.sqrt(1152), torch.bfloat16),
                   torch.ones(256, device="cuda"),
                   card((rng.standard_normal(256) * 0.1).astype(np.float32)),
                   card(rng.standard_normal((256, cout)).astype(np.float32)
                        / 16, torch.bfloat16),
                   torch.ones(cout, device="cuda"),
                   card(rng.uniform(-10, 10, cout).astype(np.float32)))
            kw = {"softmax_lanes": cout} if soft else {}
            notes.append(held(
                f"head[bf16-{cout}{'-softmax' if soft else ''}] {B}x{h}x{w}",
                tail_fused.head, head_plain, x, tail_fused.prepare_head(*raw),
                raw, kw, "head"))
    for M in REDESIGNED_DOT_ROWS:
        for dtype in ("int8", "bf16", "f32"):
            for cout in ((65, 256) if dtype != "f32" else (64,)):
                cin = 9 if dtype == "f32" else 256
                if dtype == "int8":
                    x = card(rng.integers(-127, 128, (M, cin)).astype(np.int8))
                    wt = card(rng.integers(-127, 128, (cin, cout)).astype(
                        np.int8))
                    m = card(rng.uniform(2e-5, 1e-4, cout).astype(np.float32))
                else:
                    to = torch.bfloat16 if dtype == "bf16" else None
                    x = card(rng.uniform(0, 1, (M, cin)).astype(np.float32),
                             to)
                    wt = card((rng.standard_normal((cin, cout))
                               / np.sqrt(cin)).astype(np.float32), to)
                    m = torch.ones(cout, device="cuda")
                raw = (wt, m, card(rng.uniform(-1, 1, cout).astype(
                    np.float32)))
                notes.append(held(
                    f"dot_bias_act[{dtype}-{cin}-{cout}] M {M}",
                    conv_stack.dot_bias_act, conv_stack.dot_bias_act_plain,
                    x, conv_stack.prepare_dot(*raw), raw,
                    {"relu": dtype == "f32"}, dtype))
    s1 = np.float32(0.02)
    for (B, h, w), pool in REDESIGNED_CONV12:
        image = card(rng.uniform(0, 1, (B, h, w, 1)).astype(np.float32))
        raw = (card((rng.standard_normal((3, 3, 1, 64)) * 0.3).astype(
                   np.float32)),
               card(np.full((64,), np.float32(1.0) / (np.float32(127.0) * s1))),
               card((rng.standard_normal(64) * 0.1 / s1).astype(np.float32)),
               card(rng.integers(-127, 128, (3, 3, 64, 64)).astype(np.int8)),
               card(rng.uniform(1e-4, 6e-4, 64).astype(np.float32)),
               card(rng.uniform(-20, 20, 64).astype(np.float32)))
        notes.append(held(
            f"conv12_fused{'[pool]' if pool else ''} {B}x{h}x{w}",
            c12.conv12_fused, conv12_fused_plain, image,
            c12.prepare_conv12(*raw), raw, {"pool": pool}, "int8"))
    for (B, h, w), pool in REDESIGNED_S8_DOUBLE:
        insts = ([(64, 64), (64, 128), (128, 128)] if pool else [(128, 128)])
        for cin, cm in insts:
            x = card(rng.integers(0, 128, (B, h, w, cin)).astype(np.int8))
            raw = (card(rng.integers(-127, 128, (3, 3, cin, cm)).astype(np.int8)),
                   card(rng.uniform(5e-5, 4e-4, cm).astype(np.float32)),
                   card(rng.uniform(-20, 20, cm).astype(np.float32)),
                   card(rng.integers(-127, 128, (3, 3, cm, cm)).astype(np.int8)),
                   card(rng.uniform(-4e-4, 4e-4, cm).astype(np.float32)),
                   card(rng.uniform(-20, 20, cm).astype(np.float32)))
            for relu in (True, False):
                notes.append(held(
                    f"double_conv3x3[{cin}-{cm}-{cm}{'-pool' if pool else ''}]"
                    f"{'' if relu else ' relu off'} {B}x{h}x{w}",
                    mid_fused.double_conv3x3, double_conv3x3_plain, x,
                    mid_fused.prepare_double_conv(*raw), raw,
                    {"pool": pool, "relu": relu}, "int8"))
    for (B, h, w), pool in REDESIGNED_S8_CONV:
        for cin, cout in ((64, 64), (64, 128), (128, 128), (128, 256)):
            if pool and cout != cin:
                continue  # the serving route pools 64-64 and 128-128 only
            x = card(rng.integers(0, 128, (B, h, w, cin)).astype(np.int8))
            raw = (card(rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)),
                   card(rng.uniform(-4e-4, 4e-4, cout).astype(np.float32)),
                   card(rng.uniform(-20, 20, cout).astype(np.float32)))
            wrapper = conv_stack.packed_conv3x3 if cin == 64 else conv_stack.conv3x3
            for relu in (True, False):
                notes.append(held(
                    f"conv3x3[int8-{cin}-{cout}{'-pool' if pool else ''}]"
                    f"{'' if relu else ' relu off'} {B}x{h}x{w}", wrapper,
                    conv_stack.conv3x3_plain, x, conv_stack.prepare_conv3x3(*raw),
                    raw, {"pool": pool, "relu": relu}, "int8"))
    for B, h, w in REDESIGNED_S8_HEAD_SHAPES:
        x = card(rng.integers(0, 128, (B, h, w, 128)).astype(np.int8))
        for cout, soft in ((65, True), (65, False), (256, False)):
            raw = (card(rng.integers(-127, 128, (3, 3, 128, 256)).astype(np.int8)),
                   card(rng.uniform(5e-5, 4e-4, 256).astype(np.float32)),
                   card(rng.uniform(-20, 20, 256).astype(np.float32)),
                   card(rng.integers(-127, 128, (256, cout)).astype(np.int8)),
                   card(rng.uniform(-1e-4, 1e-4, cout).astype(np.float32)),
                   card(rng.uniform(-1, 1, cout).astype(np.float32)))
            kw = {"softmax_lanes": cout} if soft else {}
            label = f"head[{cout}{'-softmax' if soft else ''}] {B}x{h}x{w}"
            prepared = tail_fused.prepare_head(*raw)
            notes.append(held(label, tail_fused.head, head_plain, x, prepared,
                              raw, kw, "head-int8"))
            if not soft:  # int32 sums and the same float32 affine
                got = tail_fused.head(x, prepared, **kw)
                if not torch.equal(got, head_plain(x, *raw, **kw)):
                    raise AssertionError(f"{label}: logits differ from "
                                         "their plain version")
    for width in REDESIGNED_WARP_WIDTHS:
        img = card(rng.uniform(0, 1, (2, 19, width, 1)).astype(np.float32))
        hs = np.tile(np.eye(3, dtype=np.float32), (6, 1, 1))
        hs[:, :2] += rng.normal(0, 0.1, (6, 2, 3)).astype(np.float32)
        hs[:, :2, 2] *= 10
        hs[:, 2, :2] = rng.normal(0, 1e-3, (6, 2)).astype(np.float32)
        hs[0] = [[1, 0, 0], [0, 1, 0], [1 / 16, 0, 1]]  # d = 0 on x = 16
        hinv = invert_homographies(card(hs))
        for dtype in (torch.bfloat16, torch.int8):
            got = warp_by_inverse(img, hinv, dtype)
            want = warp_by_inverse_plain(img, hinv, dtype)
            err = float((got - want).abs().max())
            if not err <= 1e-6:
                raise AssertionError(f"warp {dtype} 2x19x{width}: max |err| "
                                     f"{err} > 1e-6")
            notes.append(f"warp {str(dtype)[6:]} 6x19x{width} {err:.1e}")
    log("[redesigned] against their plain versions, prepared = raw = "
        "second launch, bit for bit (share differing / beyond 1 bf16 ulp; "
        "the warp's max |err|): " + "; ".join(notes))


def phase_modes_small(sp_cuda_int8, cfg):
    """The bf16, mixed and unfused graphs on the card against the CPU
    plain path (same weights and scales) on 2 images of 32 x 64 and
    32 x 56."""
    params = {k: {n: t.cpu() for n, t in v.items()}
              for k, v in sp_cuda_int8.params.items()}
    scales = {k: v.cpu() for k, v in sp_cuda_int8.act_scales.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst = []
    for width in (64, 56):
        x = synthetic_images(2, gen)[:, :32, :width].contiguous()
        n_all = 4 * (width // 8) * 64  # every pixel a candidate
        for mode, fused_mid, fused_tail in SMALL_ROUTES:
            kw = dict(mode=mode, fused_mid=fused_mid, fused_tail=fused_tail)
            sps = [serving.ServingSuperPoint(
                params, None if mode == "bf16" else scales,
                sp_cuda_int8.has_descriptor, device=dev, **kw)
                for dev in ("cuda", "cpu")]
            got, want = (sp(x.to(sp.device), softmax=fused_tail)
                         for sp in sps)
            name = f"{mode} fused_mid={fused_mid} fused_tail={fused_tail} " \
                   f"2x32x{width}"
            det = "probs" if fused_tail else "logits"
            for key in (det, "desc_raw"):
                g, w = got[key].cpu(), want[key]
                err = float((g.float() - w.float()).abs().max())
                scale = float(w.float().abs().max())
                if mode == "int8":
                    ok, note = bf16_ulps(g, w) <= 1, f"{bf16_ulps(g, w)} ulps"
                elif mode == "bf16":
                    d = float(bf16_scaled_ulps(g, w, 1.0).max())
                    ok, note = d <= 1, f"{d} ulps of the largest"
                else:
                    d = bf16_scaled_ulps(g, w, BF16_FLOOR)
                    share = float((d > 1).float().mean())
                    ok = share <= 1e-3 and err <= 1e-2 * scale
                    note = f"{share:.3e} beyond 1 ulp"
                if not ok:
                    raise AssertionError(f"small {name}: {key} {note}, max "
                                         f"|err| {err}")
                worst.append(f"{mode}/{int(fused_tail)}/{width} {key} {note}")
            sets = []
            for out in (got, want):
                if fused_tail:
                    pts, _, valid = detect_from_probs_padded(
                        out["probs"].cpu(), cfg.grid_size,
                        min_prob=cfg.det_thresh, size=cfg.nms,
                        num_candidates=n_all, top_k=n_all, compact=False)
                else:
                    pts, _, valid = detect_from_logits(
                        out["logits"].cpu(), cfg.grid_size,
                        min_prob=cfg.det_thresh, size=cfg.nms,
                        num_candidates=n_all, top_k=n_all)
                sets.append({tuple(p) for p in pts[valid].tolist()})
            apart = max(len(sets[0] - sets[1]), len(sets[1] - sets[0]))
            if not sets[1] or apart > max(1, 0.01 * len(sets[1])) or (
                    mode == "int8" and apart):
                raise AssertionError(f"small {name}: {apart} of "
                                     f"{len(sets[1])} keypoints apart")
            pts = pts.cpu()
            d_cuda = sample_descriptors_onehot(got["desc_raw"],
                                               pts.cuda()).cpu()
            d_cpu = sample_descriptors_onehot(want["desc_raw"], pts)
            cos = float((d_cuda * d_cpu).sum(-1)[valid].min())
            if cos < 0.999:
                raise AssertionError(f"small {name}: descriptor cosine {cos}")
            worst.append(f"{mode}/{int(fused_tail)}/{width} keypoints "
                         f"{apart} apart of {len(sets[1])}, cosine {cos:.6f}")
    log("[modes-small] card against the CPU plain path: " + "; ".join(worst))


def phase_small_reference(sp_cuda, cfg):
    """The CUDA graph against the plain path on the CPU (same weights and
    scales) on 2 images of 64 x 128."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = synthetic_images(2, gen)[:, :64, :128].contiguous()
    sp_cpu = serving.ServingSuperPoint(
        {k: {n: t.cpu() for n, t in v.items()} for k, v in sp_cuda.params.items()},
        {k: v.cpu() for k, v in sp_cuda.act_scales.items()},
        sp_cuda.has_descriptor, device="cpu")
    got, want = sp_cuda(x, softmax=True), sp_cpu(x.cpu(), softmax=True)
    for key in ("probs", "desc_raw"):
        ulps = bf16_ulps(got[key].cpu(), want[key])
        if ulps > 1:
            raise AssertionError(f"small input: {key} differs by {ulps} ulps")
    n_all = 8 * 16 * 64  # every pixel a candidate: sets independent of ties
    sets = []
    for probs in (got["probs"], got["probs"].cpu()):
        pts, _, valid = detect_from_probs_padded(
            probs, cfg.grid_size, min_prob=cfg.det_thresh, size=cfg.nms,
            num_candidates=n_all, top_k=n_all, compact=False)
        sets.append({tuple(p) for p in pts[valid].cpu().tolist()})
    if sets[0] != sets[1] or not sets[0]:
        raise AssertionError("small input: keypoint sets differ")
    pts = pts.cpu()
    d_cuda = sample_descriptors_onehot(got["desc_raw"], pts.cuda()).cpu()
    d_cpu = sample_descriptors_onehot(got["desc_raw"].cpu(), pts)
    cos = float((d_cuda * d_cpu).sum(-1).min())
    if cos < 0.999:
        raise AssertionError(f"small input: descriptor cosine {cos}")
    # the whole CPU path, once, as a user would call it
    make_infer(sp_cpu, cfg, TOP_K)(x.cpu())
    log(f"[small] 2x64x128: probs/desc_raw within 1 bf16 ulp of the CPU "
        f"plain path, {len(sets[0])} keypoints equal, min descriptor "
        f"cosine {cos:.6f}")


def export_config(serving=False, **ha) -> dict:
    config = copy.deepcopy(EXPORT_CONFIG)
    config["homography_adaptation"].update(ha)
    config["export"] = {"serving": serving}
    return config


def ha_model():
    """Seeded full-width MagicPoint, the detector's last conv times
    ``DET_GAIN``."""
    model = init_superpoint(SEED + 3,
                            SuperPointConfig.from_dict(EXPORT_CONFIG["model"]),
                            device="cuda")
    with torch.no_grad():
        model.detector["convPb"].Conv_0.weight.mul_(DET_GAIN)
    return model


def ha_prob_fn(model, config, calib):
    """The forward ``export_pseudo_labels`` builds for ``config``."""
    mode = config["export"]["serving"]
    if mode:
        sp = serving.ServingSuperPoint.build(
            model.config, model, calib,
            mode=mode if isinstance(mode, str) else "int8", device="cuda")
        return export.make_prob_fn(model, serving=sp)
    return export.make_prob_fn(model, fast=True)


@contextlib.contextmanager
def recorded_warps(calls: list, keep: int):
    """Record the operands (image, H^-1, dtype) of the first ``keep``
    warp calls HA makes."""
    saved = ha_mod.warp_by_inverse

    def call(image, hinv, compute_dtype):
        if len(calls) < keep:
            calls.append((image, hinv, compute_dtype))
        return saved(image, hinv, compute_dtype)

    ha_mod.warp_by_inverse = call
    try:
        yield
    finally:
        ha_mod.warp_by_inverse = saved


def run_export(model, images, config, root: Path):
    """export_pseudo_labels over ``images`` (n, H, W, 1) numpy into
    ``root``; (label directory, seconds until the last file is written)."""
    data = [{"image": im, "name": f"img{i:04d}"} for i, im in enumerate(images)]
    loader = DataLoader(data, config["data"]["batch_size"], drop_last=False)
    export.EXPER_PATH = root
    t0 = time.perf_counter()
    out_dir = export.export_pseudo_labels(config, model, loader)
    torch.cuda.synchronize()
    return out_dir, time.perf_counter() - t0


def phase_ha_export(model, images, route, config):
    """Drive export_pseudo_labels once (after a warm-up batch) with the
    launch counters at 0 before; check files and launches."""
    ha = config["homography_adaptation"]
    n_chunks = -(-(ha["num"] - 1) // ha["chunk"])
    n_batches = -(-len(images) // config["data"]["batch_size"])
    with tempfile.TemporaryDirectory() as tmp:
        run_export(model, images[:8], config, Path(tmp, "warm-up"))
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        out_dir, secs = run_export(model, images, config, Path(tmp, "run"))
        counts = dict(_build.launch_counts)
        n_pts = check_labels(out_dir, len(images))
        # the same export again, for the spread of the time
        _, again = run_export(model, images, config, Path(tmp, "again"))
    warp_key = "warp[int8]" if ha.get("compute_dtype") == "int8" else "warp[bf16]"
    expect = {warp_key: 2 * n_chunks}
    if config["export"]["serving"]:
        fwd = n_chunks + 1  # the identity view and one forward per chunk
        expect.update({"conv12_fused": fwd, "double_conv3x3": 3 * fwd,
                       "head": fwd})
    for family, per_batch in expect.items():
        n = sum(v for k, v in counts.items() if k.startswith(family))
        if n != per_batch * n_batches:
            raise AssertionError(f"{route}: {family} launched {n} times, "
                                 f"expected {per_batch} per batch")
    log(f"[ha] {route}: {len(images)} images of {HA_H}x{HA_W} in "
        f"{n_batches} batches, {secs:.4f} s, {len(images) / secs:.2f} "
        f"images/s, {secs / n_batches * 1e3:.3f} ms per batch (run again: "
        f"{again:.4f} s, {len(images) / again:.2f} images/s); keypoints "
        f"per image min {min(n_pts)} median {statistics.median(n_pts)} max "
        f"{max(n_pts)}")
    log(f"[ha] {route} launches: {json.dumps(counts, sort_keys=True)}")
    return counts


def phase_ha_split(model, images, route, config, serving_calls=None):
    """One batch of 8 split into its parts, each timed apart by CUDA
    events (medians of 5): forwards, warps, masks with their inverses,
    NMS + top-k; homography sampling and file writes by the host clock.
    Returns the operands of its first image warp and probability
    unwarp."""
    cfg = HAConfig.from_dict(config["homography_adaptation"])
    det = config["model"]["detector_head"]
    x = torch.from_numpy(images[:8]).cuda()
    prob_fn = ha_prob_fn(model, config, x)
    B = x.shape[0]
    n_extra = cfg.num - 1
    t0 = time.perf_counter()
    homs = image_homographies(SEED, range(B), n_extra, (HA_H, HA_W),
                              cfg.params)
    sample_ms = (time.perf_counter() - t0) * 1e3
    homs = homs.cuda()
    ha_ms = cuda_ms(lambda: homography_adaptation(prob_fn, x, homs, cfg),
                    reps=3)
    calls = []  # image warp and unwarp of each chunk
    with recorded_warps(calls, keep=2 * -(-n_extra // cfg.chunk)):
        prob = homography_adaptation(prob_fn, x, homs, cfg)
    torch.cuda.synchronize()
    warp_ms = sum(cuda_ms(lambda c=c: warp_by_inverse(*c), reps=5)
                  for c in calls)
    fwd_ms = cuda_ms(lambda: prob_fn(x), reps=5)
    invs = invert_homographies(homs.transpose(0, 1))
    inv_invs = invert_homographies(invs)
    mask_ms = cuda_ms(lambda: invert_homographies(invert_homographies(
        homs.transpose(0, 1))), reps=5)
    for c0 in range(0, n_extra, cfg.chunk):
        h_inv, h_inv_inv = (t[c0:c0 + cfg.chunk].reshape(-1, 3, 3)
                            for t in (invs, inv_invs))
        warped = warp_by_inverse(*calls[2 * (c0 // cfg.chunk)])
        fwd_ms += cuda_ms(lambda: prob_fn(warped), reps=5)
        if serving_calls is not None and c0 == 0:
            with recorded_calls(serving_calls):  # the int8 kernels at k * B
                prob_fn(warped)

        def masks():
            for h in (h_inv, h_inv_inv):
                valid_mask_from_inverse((HA_H, HA_W), h,
                                        cfg.valid_border_margin)
        mask_ms += cuda_ms(masks, reps=5)

    def nms_topk():
        pn = box_nms(prob, size=det["nms"], iou=0.1,
                     min_prob=det["det_thresh"])
        return torch.topk(pn.reshape(B, -1), 4096, dim=1)
    nms_ms = cuda_ms(nms_topk, reps=5)
    scores, idx = nms_topk()
    scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for i in range(B):
            keep = scores[i] >= det["det_thresh"]
            pts = np.stack([idx[i][keep] // HA_W, idx[i][keep] % HA_W], -1)
            np.save(Path(tmp, f"{i}.npy"), pts.astype(np.int64))
        write_ms = (time.perf_counter() - t0) * 1e3
    other = ha_ms - fwd_ms - warp_ms - mask_ms
    log(f"[ha-split] {route}, one batch of {B} at {HA_H}x{HA_W}: adaptation "
        f"{ha_ms:.3f} ms (median of 3) = forwards {fwd_ms:.3f} + warps "
        f"{warp_ms:.3f} ({len(calls)} launches) + masks {mask_ms:.3f} + "
        f"rest {other:.3f}; homography sampling on the host {sample_ms:.3f} "
        f"ms; NMS + top-k {nms_ms:.3f} ms; host writes {write_ms:.3f} ms")
    return calls[:2]


def phase_warp_kernels(calls, peaks):
    """The warp kernel against its plain version on HA's operands, with
    times (around one call and the device time alone), the bound and
    F.grid_sample on the same images."""
    _, mem_rate, f32_rate = peaks[:3]
    rows = []
    for label, (image, hinv, dtype) in calls:
        before = _build.launch_counts.copy()
        got = warp_by_inverse(image, hinv, dtype)
        key, = (_build.launch_counts - before).keys()
        want = warp_by_inverse_plain(image, hinv, dtype)
        err = float((got - want).abs().max())
        share = float((got != want).float().mean())
        if not err <= 1e-6:
            raise AssertionError(f"{key} {label}: max |err| {err} > 1e-6")
        ms = cuda_ms(lambda: warp_by_inverse(image, hinv, dtype), reps=20,
                     warmup=3)
        dev_ms, how = device_ms(lambda: warp_by_inverse(image, hinv, dtype),
                                "warp_")
        plain_ms = cuda_ms(lambda: warp_by_inverse_plain(image, hinv, dtype),
                           reps=3)
        N, B = hinv.shape[0], image.shape[0]
        src = image.permute(0, 3, 1, 2).repeat(N // B, 1, 1, 1)
        sx, sy = source_coords(hinv, (HA_H, HA_W))
        grid = torch.stack([sx * (2.0 / (HA_W - 1)) - 1.0,
                            sy * (2.0 / (HA_H - 1)) - 1.0], -1)
        grid = torch.where(torch.isfinite(grid), grid, -2.0)
        def lib():
            return F.grid_sample(src, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)
        lib_ms = cuda_ms(lib, reps=20, warmup=3)
        lib_dev_ms = device_ms(lib)[0]
        moved = nbytes(image, got) + N * 9 * 4  # and H^-1, read once
        ops = N * HA_H * HA_W * WARP_FLOPS_PER_PIXEL
        t_ops, t_bytes = ops / f32_rate * 1e3, moved / mem_rate * 1e3
        rows.append({
            "name": key, "route": "cuda",
            "source": "spnerf_tpu_torch/kernels/csrc/warp.cu",
            "replaces": "spnerf_tpu/kernels/warp_pallas.py:74",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "device_ms": dev_ms,
            "library_device_ms": lib_dev_ms,
        })
        log(f"[kernel] {key} {label}: {B} images -> {N} warps "
            f"{HA_H}x{HA_W}, max_abs_err {err} ({share:.3e} of values "
            f"differ), kernel {ms:.4f} ms (median of 20; device "
            f"{dev_ms:.4f} ms by {how}), plain {plain_ms:.4f} ms, "
            f"grid_sample {lib_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
            f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}, "
            f"{moved / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
        del got, want, src, grid, lib
        torch.cuda.empty_cache()
    return rows


def phase_ha_small(model):
    """HA by the int8 route on 2 images of 64 x 80 (num 5, chunk 2) on the
    card and on the CPU plain path, same weights, scales and
    homographies: heatmaps within HA_SMALL_TOL, keypoint sets equal."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = synthetic_images(2, gen, (64, 80))
    cfg = HAConfig.from_dict({**EXPORT_CONFIG["homography_adaptation"],
                              "num": 5, "chunk": 2})
    det = EXPORT_CONFIG["model"]["detector_head"]
    sp = serving.ServingSuperPoint.build(model.config, model, x,
                                         device="cuda")
    sp_cpu = serving.ServingSuperPoint(
        {k: {n: t.cpu() for n, t in v.items()} for k, v in sp.params.items()},
        {k: v.cpu() for k, v in sp.act_scales.items()},
        sp.has_descriptor, device="cpu")
    homs = image_homographies(SEED, [0, 1], cfg.num - 1, (64, 80), cfg.params)
    probs, sets = [], []
    for spx, dev in ((sp, "cuda"), (sp_cpu, "cpu")):
        prob = homography_adaptation(export.make_prob_fn(model, serving=spx),
                                     x.to(dev), homs.to(dev), cfg)
        nms = box_nms(prob, size=det["nms"], iou=0.1,
                      min_prob=det["det_thresh"])
        sets.append({tuple(p) for p in nms.nonzero().cpu().tolist()})
        probs.append(prob.cpu())
    err = float((probs[0] - probs[1]).abs().max())
    if not err <= HA_SMALL_TOL:
        raise AssertionError(f"HA small: heatmaps differ by {err}")
    if not sets[0]:
        raise AssertionError("HA small: no keypoint")
    if sets[0] != sets[1]:
        diff = sorted(sets[0] ^ sets[1])
        raise AssertionError(
            f"HA small: keypoint sets differ at {diff[:10]} (card "
            f"{len(sets[0])}, CPU {len(sets[1])})")
    log(f"[ha-small] 2x64x80, num 5: heatmaps within {err:.3e} of the CPU "
        f"plain path ({float((probs[0] != probs[1]).float().mean()):.3e} "
        f"of values differ), {len(sets[0])} keypoints, equal sets")


def train_config() -> dict:
    """TRAIN_CONFIG with TRAIN_CUTS applied."""
    return _cut(TRAIN_CONFIG, TRAIN_CUTS)


def train_dataset(n: int, seed: int, size=(TRAIN_H, TRAIN_W)) -> list:
    """``n`` samples {"image": (H, W, 1) float32 synthetic image, "kpts":
    (256, 2) seeded (y, x) keypoints, "kpts_mask": all true}."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    images = synthetic_images(n, gen, size).cpu().numpy()
    rng = np.random.default_rng(seed)
    kpts = rng.uniform(0, size, (n, TRAIN_KPTS, 2)).astype(np.float32)
    return [{"image": images[i], "kpts": kpts[i],
             "kpts_mask": np.ones(TRAIN_KPTS, bool)} for i in range(n)]


@contextlib.contextmanager
def recorded_hinge_calls(calls: list):
    """Record the operands of every ``descriptor_hinge_sums`` call."""
    saved = dl.descriptor_hinge_sums

    def call(*args):
        calls.append(tuple(a.detach() if torch.is_tensor(a) else a
                           for a in args))
        return saved(*args)

    dl.descriptor_hinge_sums = call
    try:
        yield
    finally:
        dl.descriptor_hinge_sums = saved


def phase_train(root: Path):
    """Drive tasks.train_task.train: 20 steps of the full-width config on
    a repeated batch, validation, a checkpoint, and a resumed step.
    Returns (launch counts of the 20-step run, the trained state, its
    loader, the operands of its last step's descriptor-loss call)."""
    settings.CKPT_PATH = root
    config = train_config()
    batch = config["data"]["batch_size"]
    # one batch, repeated: the loss must fall on it; validation on 2 others
    loader = DataLoader(train_dataset(batch, SEED + 6), batch)
    val_loader = DataLoader(train_dataset(2 * batch, SEED + 7), batch)

    warm = dict(config, ckpt_name="warm_up",
                train=dict(config["train"], num_iters=3))
    train_task.train(warm, loader, seed=SEED, device=DEV)  # cuDNN plans, allocator pools
    torch.cuda.synchronize()

    hinge_calls = []
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    with recorded_hinge_calls(hinge_calls):
        state = train_task.train(config, loader, val_loader=val_loader,
                                 validate_training=True, seed=SEED,
                                 device=DEV)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.launch_counts)

    steps = config["train"]["num_iters"]
    n_val = config["train"]["val_batches"]
    name = config["ckpt_name"]
    if state.iteration != steps:
        raise AssertionError(f"train: {state.iteration} steps of {steps}")
    expect = {"desc_loss[fwd]": steps + n_val, "desc_loss[dA]": steps,
              "desc_loss[dB]": steps}
    got = {k: v for k, v in counts.items() if k.startswith("desc_loss")}
    if got != expect:
        raise AssertionError(f"train: launches {got}, expected {expect}")
    metrics = read_metrics(name)
    for tag, rows in metrics.items():
        if not all(np.isfinite(v) for _, v in rows):
            raise AssertionError(f"train: {tag} is not finite: {rows}")
    losses = metrics["iter_loss/loss"]
    if [s for s, _ in losses] != [5, 10, 15, 20]:
        raise AssertionError(f"train: loss logged at {losses}")
    if not losses[-1][1] < losses[0][1]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    for tag in ("val/val_loss", "val/precision", "val/recall"):
        if len(metrics[tag]) != 1:
            raise AssertionError(f"train: {tag} logged {metrics[tag]}")
    ckpt = Path(root, name, f"{name}_{steps}.ckpt")
    saved = loop.load_checkpoint(ckpt)
    if saved["iteration"] != steps or not all(
            torch.isfinite(t).all() for t in saved["params"].values()):
        raise AssertionError("train: bad checkpoint")
    rates = [v for _, v in metrics["perf/steps_per_sec"]]
    log(f"[train] {steps} steps of batch {batch} at {TRAIN_H}x{TRAIN_W} "
        f"(cuts: {json.dumps(TRAIN_CUTS)}; synthetic images, "
        f"{TRAIN_KPTS} seeded keypoints each, seeded weights) + validation "
        f"of {n_val} batches + checkpoint in {secs:.4f} s; steps/s per "
        f"window of 5 steps: {', '.join(f'{r:.2f}' for r in rates)}; loss "
        f"{', '.join(f'{s}: {v:.4f}' for s, v in losses)}; descriptor "
        f"loss {metrics['iter_loss/descriptor_loss'][-1][1]:.6f}; val loss "
        f"{metrics['val/val_loss'][0][1]:.4f} precision "
        f"{metrics['val/precision'][0][1]:.4f} recall "
        f"{metrics['val/recall'][0][1]:.4f}; checkpoint "
        f"{ckpt.stat().st_size / 1e6:.1f} MB")
    log(f"[train] launches: {json.dumps(counts, sort_keys=True)}")

    # one more step, resumed from the checkpoint
    before = _build.launch_counts.copy()
    resume = dict(config, ckpt_name="resumed", continue_training=True,
                  pretrained=f"{name}/{name}_{steps}.ckpt",
                  train=dict(config["train"], num_iters=steps + 1))
    resumed = train_task.train(resume, loader, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    delta = _build.launch_counts - before
    loss = read_metrics("resumed")["iter_loss/loss"]
    if (resumed.iteration != steps + 1 or len(loss) != 1
            or not np.isfinite(loss[0][1])
            or delta != {k: 1 for k in expect}):
        raise AssertionError(f"train: resumed step: iteration "
                             f"{resumed.iteration}, loss {loss}, launches "
                             f"{dict(delta)}")
    log(f"[train] resumed from step {steps}: step {loss[0][0]} loss "
        f"{loss[0][1]:.4f}, launches {json.dumps(dict(delta), sort_keys=True)}")
    # the 20th step's call, not validation's
    return counts, state, loader, hinge_calls[steps - 1]


def phase_data_parallel():
    """``[dist]``: two ranks on this card through gloo, one through NCCL
    (``tools/smoke_dist.phase_dist``), on 16 synthetic HA images and a
    batch of ``train_dataset``; each rank's launch counters at 0 before
    its work. Returns the ranks' launches on the sharded path."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    images = synthetic_images(smoke_dist.DIST_IMAGES, gen,
                              (HA_H, HA_W)).cpu().numpy()
    config = train_config()
    batch = collate(train_dataset(config["data"]["batch_size"], SEED + 31))
    with tempfile.TemporaryDirectory() as tmp:
        return smoke_dist.phase_dist(Path(tmp), ha_model(), images,
                                     export_config(serving="int8"), config,
                                     batch, SEED)


def phase_train_split(state, loader, reps: int = 5):
    """One training step split into its parts by CUDA events (medians of
    ``reps`` steps; each step is a real one, on the trained state):
    augmentation and batch preparation, the two forwards, the three
    losses, the backward, Adam."""
    cfg = train_task.build_step_config(train_config(), include_mask=True)
    gens = loop.StepGenerators(SEED, DEV)
    batch = train_task._to_device(next(iter(loader)), DEV)
    model, opt = state.model, state.optimizer
    names = ("augmentation", "forwards", "losses", "backward", "adam")
    times = {n: [] for n in names}
    whole = []
    for rep in range(reps + 1):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        gens.reseed(2, rep)
        marks[0].record()
        with torch.no_grad():
            b = dict(batch)
            b["image"] = loop.photometric_augment(
                gens.cpu, batch["image"], cfg.photometric, gens.device)
            b["image_warp_src"] = loop.photometric_augment(
                gens.cpu, batch["image"], cfg.photometric, gens.device)
            data = loop._prepare(b, cfg, gens)
            noise = [loop._noise(gens, data[v]["image"], cfg.grid_size)
                     for v in ("raw", "warp")]
        marks[1].record()
        opt.zero_grad(set_to_none=True)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            model.train()
            out = model(data["raw"]["image"])
            warped_out = model(data["warp"]["image"])
            marks[2].record()
            det = detector_loss(noise[0], out["logits"],
                                data["raw"]["kpts_heatmap"],
                                data["raw"]["valid_mask"], cfg.grid_size)
            det_w = detector_loss(noise[1], warped_out["logits"],
                                  data["warp"]["kpts_heatmap"],
                                  data["warp"]["valid_mask"], cfg.grid_size)
            _, Hc, Wc, _ = out["desc_raw"].shape
            cells = cell_grid_coords(Hc, Wc, cfg.grid_size, device=DEV)
            desc, _, _ = dl.descriptor_loss_blockwise(
                out["desc_raw"], warped_out["desc_raw"],
                warp_points(cells, data["homography"]), cfg.desc_cfg,
                data["warp"]["valid_mask"])
            loss = det + det_w + desc
            marks[3].record()
            loss.backward()
        marks[4].record()
        opt.step()
        marks[5].record()
        marks[5].synchronize()
        if rep == 0:
            continue  # warm-up
        for n, a, z in zip(names, marks[:-1], marks[1:]):
            times[n].append(a.elapsed_time(z))
        whole.append(marks[0].elapsed_time(marks[5]))
    med = {n: statistics.median(v) for n, v in times.items()}
    log(f"[train-split] one step of batch 2 at {TRAIN_H}x{TRAIN_W}: "
        f"{statistics.median(whole):.3f} ms (median of {reps}) = "
        + " + ".join(f"{n} {med[n]:.3f}" for n in names)
        + f"; last loss {float(loss.detach()):.4f}")
    return med


def phase_desc_loss_kernels(cases, peaks):
    """The three descriptor-loss kernels against the plain version, with
    times (around the call, and the device time alone by ``torch.profiler``:
    every ``hinge_`` kernel of the call), two bounds (float32 on the CUDA
    cores; the same float32-grade work on the TF32 tensor cores: 3 passes a
    dot, 2 for a gradient product; the row takes the lower), the share of
    pairs the gradient kernels' band summed again in float64 (their
    counter, ``repaired_pairs``) and the dense loss with autograd as a
    yardstick. Returns the rows of the first case (the training step's
    operands)."""
    _, mem_rate, f32_rate, bf16_rate = peaks[:4]
    tf32_rate = bf16_rate / 2  # dense TF32 is half the bf16 rate on Hopper
    source = "spnerf_tpu_torch/kernels/csrc/descriptor_loss.cu"
    replaces = {
        "desc_loss[fwd]": "spnerf_tpu/kernels/descriptor_loss_pallas.py:172",
        "desc_loss[dA]": "spnerf_tpu/kernels/descriptor_loss_pallas.py:223",
        "desc_loss[dB]": "spnerf_tpu/kernels/descriptor_loss_pallas.py:247"}
    first = None
    for label, args in cases:
        A, Bm, wcells, cells, mask = (t.detach().clone() for t in args[:5])
        params = args[5:]
        B, N, C = A.shape
        M = Bm.shape[1]
        A.requires_grad_()
        Bm.requires_grad_()
        g = torch.linspace(0.5, 1.5, B, device=DEV)  # S_pair's cotangent

        def run(fn):
            sums = fn(A, Bm, wcells, cells, mask, *params)
            dA, dB = torch.autograd.grad((sums[0] * g).sum(), (A, Bm))
            return torch.stack([s.detach() for s in sums]), dA, dB

        before = _build.launch_counts.copy()
        repairs = dl.repaired_pairs(DEV)
        got = run(dl.descriptor_hinge_sums)
        repaired = [b - a for a, b in zip(repairs, dl.repaired_pairs(DEV))]
        again, want = run(dl.descriptor_hinge_sums), run(dl.hinge_sums_plain)
        torch.cuda.synchronize()
        launched = _build.launch_counts - before
        if launched != {"desc_loss[fwd]": 2, "desc_loss[dA]": 2,
                        "desc_loss[dB]": 2}:
            raise AssertionError(f"desc_loss {label}: launches "
                                 f"{dict(launched)}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"desc_loss {label}: two runs differ")
        errs = {"desc_loss[fwd]": float((got[0] - want[0]).abs().max())}
        rel = float(((got[0] - want[0]).abs()
                     / want[0].abs().clamp_min(1e-30)).max())
        if not rel <= DESC_SUM_RTOL:
            raise AssertionError(f"desc_loss[fwd] {label}: sums differ by "
                                 f"{rel:.3e} relative")
        flipped = {}
        for key, k, p in (("desc_loss[dA]", got[1], want[1]),
                          ("desc_loss[dB]", got[2], want[2])):
            row_err = (k - p).abs().amax(-1)
            tol = DESC_GRAD_TOL * float(p.abs().max())
            bad = row_err > tol
            flipped[key] = int(bad.sum())
            if flipped[key] > DESC_FLIPPED_ROWS * bad.numel():
                raise AssertionError(
                    f"{key} {label}: {flipped[key]} of {bad.numel()} rows "
                    f"differ by more than {tol:.3e}")
            errs[key] = float(row_err[~bad].max())

        # the tensor cores' dots against float64: within the bound delta
        # that csrc/descriptor_loss.cu derives (the band is twice it)
        exact = torch.einsum("bnc,bmc->bnm", A.detach().double(),
                             Bm.detach().double())
        norms = (A.detach().double().norm(dim=-1)[:, :, None]
                 * Bm.detach().double().norm(dim=-1)[:, None, :])
        dot_err = (dl.tensor_core_dots(A.detach(), Bm.detach()).double()
                   - exact).abs()
        delta_used = float((dot_err / (dl.kappa(C) * norms)).max())
        if not delta_used <= 1.0:
            raise AssertionError(f"desc_loss {label}: a tensor-core dot "
                                 f"lies {delta_used:.3f} delta from the "
                                 "exact dot")
        del exact, norms, dot_err

        def grad_of(fn, a, b, wrt):
            # only the side that requires a gradient gets its kernel
            s_pair = fn(a, b, wcells, cells, mask, *params)[0]
            return lambda: torch.autograd.grad((s_pair * g).sum(), wrt,
                                               retain_graph=True)

        hinge, plain = dl.descriptor_hinge_sums, dl.hinge_sums_plain
        timed = {
            "desc_loss[fwd]": (
                lambda: hinge(A, Bm, wcells, cells, mask, *params),
                lambda: plain(A, Bm, wcells, cells, mask, *params)),
            "desc_loss[dA]": (grad_of(hinge, A, Bm.detach(), A),
                              grad_of(plain, A, Bm.detach(), A)),
            "desc_loss[dB]": (grad_of(hinge, A.detach(), Bm, Bm),
                              grad_of(plain, A.detach(), Bm, Bm)),
        }
        # yardstick: the dense loss the trainer takes without the kernels,
        # forward and backward; no single PyTorch call computes the function
        cfg = DescriptorLossConfig.from_dict(
            TRAIN_CONFIG["model"]["descriptor_head"])
        Hc = int(cells[:, 0].max().item() // 8) + 1
        shape4 = (B, Hc, N // Hc, C)
        valid = mask.reshape(B, Hc, N // Hc).repeat_interleave(
            8, 1).repeat_interleave(8, 2)

        def dense_fwd():
            return descriptor_loss_from_cells(
                A.reshape(shape4), Bm.reshape(shape4), wcells, cfg, valid)[0]

        dense_ms = cuda_ms(dense_fwd, reps=5)
        dense_loss = dense_fwd()
        dense_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
            dense_loss, (A, Bm), retain_graph=True), reps=5)
        del dense_loss
        pairs = B * N * M
        coords = nbytes(wcells, cells, mask)
        # (float32 operations, TF32 tensor-core operations, bytes): a
        # float32-grade dot is 3 TF32 passes, a gradient product 2 more
        work = {
            "desc_loss[fwd]": (pairs * (2 * C + DESC_PAIR_FLOPS_FWD),
                               pairs * 3 * 2 * C,
                               nbytes(A, Bm) + coords + B * 3 * 4),
            "desc_loss[dA]": (pairs * (4 * C + DESC_PAIR_FLOPS_BWD),
                              pairs * 5 * 2 * C,
                              nbytes(A, Bm, A) + coords + B * 4),
            "desc_loss[dB]": (pairs * (4 * C + DESC_PAIR_FLOPS_BWD),
                              pairs * 5 * 2 * C,
                              nbytes(A, Bm, Bm) + coords + B * 4),
        }
        share = {"desc_loss[dA]": repaired[0] / pairs,
                 "desc_loss[dB]": repaired[1] / pairs}
        rows = []
        for key, (run_kernel, run_plain) in timed.items():
            ms = cuda_ms(run_kernel, reps=20, warmup=3)
            dev_ms, how = device_ms(run_kernel, "hinge_")
            plain_ms = cuda_ms(run_plain, reps=5)
            ops, tc_ops, moved = work[key]
            t_f32, t_tf32 = ops / f32_rate * 1e3, tc_ops / tf32_rate * 1e3
            t_ops, t_bytes = min(t_f32, t_tf32), moved / mem_rate * 1e3
            rows.append({
                "name": key, "route": "cuda", "source": source,
                "replaces": replaces[key], "launches": None,
                "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None, "device_ms": dev_ms,
                "bound_f32_ms": t_f32, "bound_tf32_ms": t_tf32,
            })
            if key in share:
                rows[-1]["repaired_share"] = share[key]
            extra = (f"sums within {rel:.3e} relative; dots within "
                     f"{delta_used:.4f} delta of the exact ones"
                     if key.endswith("fwd]")
                     else f"{flipped[key]} of {B * N} rows beyond "
                          f"{DESC_GRAD_TOL} of the largest entry; the band "
                          f"summed {share[key]:.3e} of the pairs again")
            log(f"[kernel] {key} {label}: B {B}, N {N}, C {C}, max_abs_err "
                f"{errs[key]:.3e} ({extra}), two runs bit-equal, kernel "
                f"{ms:.4f} ms (median of 20; device {dev_ms:.4f} ms by "
                f"{how}), plain {plain_ms:.4f} ms, bound "
                f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}: "
                f"float32 {t_f32:.4f} ms, {ops / 1e9:.2f} GFLOP; TF32 "
                f"{t_tf32:.4f} ms, {tc_ops / 1e9:.2f} GFLOP; "
                f"{moved / 1e6:.1f} MB)")
        total = sum(r["ms"] for r in rows)
        log(f"[kernel] desc_loss {label}: forward + dA + dB {total:.4f} ms "
            f"against the dense descriptor_loss_from_cells with autograd "
            f"{dense_ms:.4f} + {dense_bwd_ms:.4f} = "
            f"{dense_ms + dense_bwd_ms:.4f} ms")
        if first is None:
            first = rows
        del timed, got, again, want
        torch.cuda.empty_cache()
    return first


def phase_train_small():
    """Two SuperPoint steps at a small size (vgg 8,8,16,16,32,32,32,32,
    heads 32, 2 images of 64 x 80) on the card, with the descriptor-loss
    kernels, and on the CPU plain path, from the same weights, the same
    draws (made on the CPU, copied to the card) and the same batch:
    augmented images within SMALL_IMAGE_ATOL, every loss of both steps
    within SMALL_LOSS_RTOL; parameters after the first step within lr / 20
    wherever the gradient is above 1e-3 of its tensor's largest (a first
    Adam step is lr * g / (|g| + 1e-8): where g is rounding noise, so is
    its direction, on both devices; the second step's losses hold the
    parameters as far as they matter)."""
    config = train_config()
    config["model"].update(vgg_cn=[8, 8, 16, 16, 32, 32, 32, 32])
    config["model"]["detector_head"]["detector_dim"] = [32, 32]
    config["model"]["descriptor_head"]["descriptor_dim"] = [32, 32]
    config["data"]["augmentation"]["photometric"]["params"][
        "additive_shade"]["kernel_size_range"] = [9, 15]
    cfg = train_task.build_step_config(config, include_mask=True)
    mcfg = SuperPointConfig.from_dict(config["model"])
    lr = config["train"]["learning_rate"]
    H, W, B = 64, 80, 2
    sample = train_dataset(B, SEED + 8, (H, W))
    host = {k: torch.from_numpy(np.stack([s[k] for s in sample]))
            for k in sample[0]}
    states = {}
    for dev in ("cpu", DEV):
        model = init_superpoint(SEED + 9, mcfg, device=dev)
        states[dev] = loop.create_train_state(model, lr)
    before = _build.launch_counts.copy()
    gen = torch.Generator().manual_seed(SEED + 10)
    worst = {"image": 0.0, "loss": 0.0, "param": 0.0}
    for step in range(2):
        draws = [draw_photometric_randoms(gen, B, H, W, cfg.photometric)
                 for _ in range(2)]
        homs = sample_homographies(gen, B, (H, W), cfg.aug)
        noise = [detector_noise(gen, (B, H // 8, W // 8, 65))
                 for _ in range(2)]
        out = {}
        for dev, state in states.items():
            to = lambda t: t.to(dev)  # noqa: E731
            batch = {k: to(v) for k, v in host.items()}
            moved = [{k: ({f: to(t) for f, t in v.items()}
                          if isinstance(v, dict) else v)
                      for k, v in d.items()} for d in draws]
            with torch.no_grad():
                batch["image_warp_src"] = photometric_from_draws(
                    batch["image"], moved[1], cfg.photometric)
                batch["image"] = photometric_from_draws(
                    batch["image"], moved[0], cfg.photometric)
                data = prepare_superpoint_batch(to(homs), batch, cfg.erosion)
            state.optimizer.zero_grad(set_to_none=True)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                loss, metrics = loop.superpoint_loss_fn(
                    state.model, data, [to(n) for n in noise], cfg.grid_size,
                    True, cfg.desc_cfg, False, True, True)
                loss.backward()
            state.optimizer.step()
            out[dev] = (data, {k: float(v.detach()) for k, v in metrics.items()})
        for view in ("raw", "warp"):
            err = float((out[DEV][0][view]["image"].cpu()
                         - out["cpu"][0][view]["image"]).abs().max())
            worst["image"] = max(worst["image"], err)
            for key in ("kpts_heatmap", "valid_mask"):
                if not torch.equal(out[DEV][0][view][key].cpu(),
                                   out["cpu"][0][view][key]):
                    raise AssertionError(f"train-small: {view} {key} differ")
        if worst["image"] > SMALL_IMAGE_ATOL:
            raise AssertionError(f"train-small: images differ by "
                                 f"{worst['image']}")
        for key, want in out["cpu"][1].items():
            rel = abs(out[DEV][1][key] - want) / abs(want)
            worst["loss"] = max(worst["loss"], rel)
            if not rel <= SMALL_LOSS_RTOL:
                raise AssertionError(
                    f"train-small: step {step} {key} {out[DEV][1][key]} "
                    f"on the card, {want} on the CPU")
        if step > 0:
            continue  # the second step's losses have held the parameters
        for (name, pc), pg in zip(states["cpu"].model.named_parameters(),
                                  states[DEV].model.parameters()):
            if name.endswith("Conv_0.bias"):
                continue  # gradient 0 through a training-mode BatchNorm
            g = pc.grad.abs()
            clear = g > 1e-3 * g.max()
            diff = (pg.detach().cpu() - pc.detach()).abs()[clear].max()
            worst["param"] = max(worst["param"], float(diff))
        if worst["param"] > lr / 20:
            raise AssertionError(f"train-small: parameters differ by "
                                 f"{worst['param']} after the first step")
    launched = _build.launch_counts - before
    if launched != {"desc_loss[fwd]": 2, "desc_loss[dA]": 2,
                    "desc_loss[dB]": 2}:
        raise AssertionError(f"train-small: launches {dict(launched)}")
    log(f"[train-small] 2 steps of 2x{H}x{W}, card against the CPU plain "
        f"path: augmented images within {worst['image']:.3e}, heatmaps and "
        f"masks equal, losses within {worst['loss']:.3e} relative, "
        f"parameters after the first step within {worst['param']:.3e} (lr "
        f"{lr}) where the gradient is clear; last loss {out[DEV][1]['loss']:.4f}")


# ---------------------------------------------------------- NeRF pairs

# magicpoint_NeRF_export.yaml and superpoint_NeRF_train.yaml, driven on two
# procedural scenes (no rendered NeRF scene is in the repository)
NERF_SHAPE, NERF_FOV = (480, 640), 44
NERF_SCENES = ("BoxRoomA", "BoxRoomB")
NERF_FRAMES = {"training": 16, "validation": 4}
NERF_EXPORT_CONFIG = load_config(CONFIGS / "magicpoint_NeRF_export.yaml")
NERF_TRAIN_CONFIG = load_config(CONFIGS / "superpoint_NeRF_train.yaml")
# the smoke run's cuts: the two procedural scenes with the labels that
# [nerf-export] wrote for them; 20 steps, validation of 2 batches and one
# checkpoint; the demo MagicPoint (partial restore; the descriptor head
# keeps its seeded weights)
NERF_CUTS = {"data.all_data_dirs": list(NERF_SCENES),
             "data.all_label_dirs": [f"outputs/MP_NeRF_v1/{s}"
                                     for s in NERF_SCENES],
             "train.num_iters": 20, "save_or_validation_interval": 20,
             "train.val_batches": 2, "log_every": 5,
             "pretrained": "pretrained/demo_mp_5000.ckpt"}
NERF_EXPORT_CUTS = {"pretrained": "pretrained/demo_mp_5000.ckpt"}
# reprojection against the analytic scene, pixels away from depth edges:
# float32 geometry, the depth stored in float32
NERF_REPROJ_TOL = 0.05
NERF_REPROJ_POINTS = 4096
NERF_MATCH_PX = 2.0
# card against CPU at 2 x 64 x 80: one NeRF step (losses, as
# SMALL_LOSS_RTOL) and one fused frame (float32 convs without TF32 and
# sums in another order: heatmaps within 1e-5, as HP_SMALL_TOL)
NERF_SMALL_SHAPE = (64, 80)


def _unit(angles: np.ndarray) -> np.ndarray:
    """(N, 2) unit vectors at ``angles``."""
    return np.stack([np.cos(angles), np.sin(angles)], -1)


def box_room(seed: int, shape=NERF_SHAPE, fov=NERF_FOV, frames=NERF_FRAMES,
             n_shapes: int = 40):
    """A procedural scene with exact geometry: the inside of a box room
    whose six walls carry seeded rotated rectangles of random gray on a
    gray ground (corners for the detector) under a fine seeded grain,
    seen by ``pose_orbit``
    cameras on an arc of radius 1 around the room's centre, looking at a
    point beside it.
    Pixel (i, j) looks along K^-1 (j, i, 1), the ray ``warp_points_nerf``
    unprojects; its along-ray depth and gray value are computed exactly
    (float64). Numpy only. Returns {"rgb" (N, H, W, 1) float32 in [0, 1],
    "depth" (N, H, W) float32, "poses" (N, 4, 4) float32, "splits"
    {split: [frame, ...]}, "room" (3,) half extents}."""
    rng = np.random.default_rng(seed)
    H, W = shape
    room = rng.uniform([2.6, 1.8, 2.6], [3.2, 2.2, 3.2])
    walls = {}  # (axis, side) -> (ground level, shapes)
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        for side in (-1.0, 1.0):
            centre = rng.uniform(-room[[u, v]], room[[u, v]], (n_shapes, 2))
            half = rng.uniform(0.1, 0.5, (n_shapes, 2))
            angle = rng.uniform(0, np.pi, n_shapes)
            level = rng.uniform(0.0, 1.0, n_shapes)
            # a fine grain (two plane waves of 3-8 cm): a rendered surface
            # is never one flat value, and exactly flat walls leave the
            # training-mode BatchNorm's one-pass variance to rounding
            waves = (rng.uniform(2 * np.pi / 0.08, 2 * np.pi / 0.03, (2, 1))
                     * _unit(rng.uniform(0, np.pi, 2)), rng.uniform(
                         0, 2 * np.pi, 2))
            walls[axis, side] = (rng.uniform(0.25, 0.75),
                                 (centre, half, angle, level), waves)
    n = sum(frames.values())
    # an arc of a 180-pose orbit: training frames every 4 degrees,
    # validation frames half-way between every fourth pair
    orbit = pose_orbit(180, radius=1.0, height=0.3, look_at=(0.3, 0.2, -0.2))
    poses = np.concatenate([orbit[0:2 * frames["training"]:2],
                            orbit[1:8 * frames["validation"]:8]])
    splits = {"training": list(range(frames["training"])),
              "validation": list(range(frames["training"], n))}

    K = camera_intrinsics(shape, fov).astype(np.float64)
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix = np.stack([jj, ii, np.ones_like(ii)], -1).reshape(-1, 3).astype(
        np.float64)
    rays = pix @ np.linalg.inv(K).T
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    rgb = np.empty((n, H, W, 1), np.float32)
    depth = np.empty((n, H, W), np.float32)
    for f in range(n):
        R, eye = poses[f, :3, :3].astype(np.float64), poses[f, :3, 3]
        d = rays @ R.T
        with np.errstate(divide="ignore"):
            t_axis = (np.sign(d) * room - eye) / d
        t_axis[~np.isfinite(t_axis) | (t_axis <= 0)] = np.inf
        hit_axis = np.argmin(t_axis, axis=-1)
        t = t_axis[np.arange(len(d)), hit_axis]
        point = eye + t[:, None] * d
        gray = np.empty(len(d), np.float64)
        for (axis, side), (ground, shapes, waves) in walls.items():
            on = (hit_axis == axis) & (np.sign(d[:, axis]) == side)
            u, v = [a for a in range(3) if a != axis]
            uv = point[on][:, [u, v]]
            value = np.full(len(uv), ground)
            for c, h, a, lv in zip(*shapes):
                rel = uv - c
                lu = rel[:, 0] * np.cos(a) + rel[:, 1] * np.sin(a)
                lw = -rel[:, 0] * np.sin(a) + rel[:, 1] * np.cos(a)
                value[(np.abs(lu) < h[0]) & (np.abs(lw) < h[1])] = lv
            (k1, k2), (p1, p2) = waves
            grain = 0.04 * np.sin(uv @ k1 + p1) * np.sin(uv @ k2 + p2)
            gray[on] = np.clip(value + grain, 0.0, 1.0)
        rgb[f, ..., 0] = gray.reshape(H, W)
        depth[f] = t.reshape(H, W)
    return {"rgb": rgb, "depth": depth, "poses": poses, "splits": splits,
            "room": room}


def project_points(points_world: np.ndarray, pose: np.ndarray, K: np.ndarray):
    """(N, 3) world points -> ((N, 2) (y, x) pixels, (N,) camera z) in the
    camera of the OpenCV cam-to-world ``pose``, float64."""
    R, t = pose[:3, :3].astype(np.float64), pose[:3, 3].astype(np.float64)
    cam = (points_world - t) @ R
    pix = cam @ K.astype(np.float64).T
    return np.stack([pix[:, 1] / pix[:, 2], pix[:, 0] / pix[:, 2]], -1), cam[:, 2]


def reprojection_truth(scene: dict, src: int, dst: int, n: int, seed: int,
                       shape=NERF_SHAPE, fov=NERF_FOV):
    """Up to ``n`` seeded pixels of frame ``src`` that lie away from depth edges
    (the 5 x 5 depth range below 0.029 and more than 2 px from the border:
    where the robust lookup takes the centre depth) and whose hit point
    frame ``dst`` sees: ((n, 2) float32 (y, x) pixels, (n, 2) float64
    analytic (y, x) in ``dst``)."""
    H, W = shape
    depth = scene["depth"][src].astype(np.float64)
    pad = np.pad(depth, 2, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(pad, (5, 5))
    flat = (win.max((-1, -2)) - win.min((-1, -2))) < 0.029
    flat[:3], flat[-2:], flat[:, :3], flat[:, -2:] = False, False, False, False
    K = camera_intrinsics(shape, fov).astype(np.float64)
    ii, jj = np.nonzero(flat)
    ray = np.stack([jj, ii, np.ones_like(ii)], -1) @ np.linalg.inv(K).T
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    pose = scene["poses"][src].astype(np.float64)
    world = pose[:3, 3] + depth[ii, jj][:, None] * (ray @ pose[:3, :3].T)
    truth, z = project_points(world, scene["poses"][dst], K)
    seen = ((z > 0) & (truth[:, 0] >= 0) & (truth[:, 0] < H - 1)
            & (truth[:, 1] >= 0) & (truth[:, 1] < W - 1))
    seen = np.nonzero(seen)[0]
    pick = np.random.default_rng(seed).choice(seen, min(n, len(seen)),
                                              replace=False)
    pts = np.stack([ii[pick], jj[pick]], -1).astype(np.float32)
    return pts, truth[pick]


def restored_model(config: dict):
    """The config's model, seeded, then restored from the demo MagicPoint
    (``config["pretrained"]`` under ``demo/``) by the port's own msgpack
    reader: the descriptor head, which the checkpoint lacks, keeps its
    seed-0 weights. On the card."""
    model = init_superpoint(SEED, SuperPointConfig.from_dict(config["model"]),
                            device=DEV)
    saved_ckpt = settings.CKPT_PATH
    settings.CKPT_PATH = Path(__file__).resolve().parent / "demo"
    try:
        train_task.restore_pretrained(config, model)
    finally:
        settings.CKPT_PATH = saved_ckpt
    return model


def nerf_export_config(scene: str) -> dict:
    """magicpoint_NeRF_export.yaml for one scene, with NERF_EXPORT_CUTS."""
    config = _cut(NERF_EXPORT_CONFIG, NERF_EXPORT_CUTS)
    config["data"].update(data_dir=scene,
                          experiment_name=f"MP_NeRF_v1/{scene}")
    return config


def phase_nerf_scenes(root: Path) -> dict:
    """Write the two procedural scenes under root/data/NeRF with
    ``write_scene`` (480 x 640, fov 44, 16 training and 4 validation frames
    each) and hold ``warp_points_nerf`` on the card to the analytic
    projection of NERF_REPROJ_POINTS seeded pixels away from depth edges
    per scene. Returns {scene: the box_room dict}."""
    settings.DATA_PATH = root / "data"
    scenes, worst, t0 = {}, 0.0, time.perf_counter()
    K = torch.from_numpy(camera_intrinsics(NERF_SHAPE, NERF_FOV)).to(DEV)[None]
    for i, name in enumerate(NERF_SCENES):
        scene = box_room(SEED + 40 + i, shape=NERF_SHAPE)
        write_scene(name, scene["rgb"], scene["depth"], scene["poses"],
                    scene["splits"])
        poses = torch.from_numpy(scene["poses"]).to(DEV)
        per_pair = NERF_REPROJ_POINTS // 4
        for src, dst in ((0, 1), (5, 3), (10, 12), (15, 13)):
            pts, truth = reprojection_truth(scene, src, dst, per_pair,
                                            SEED + src, shape=NERF_SHAPE)
            if len(pts) < per_pair:
                raise AssertionError(f"[nerf-scenes] {name}: {len(pts)} "
                                     "pixels away from depth edges")
            depth = torch.from_numpy(scene["depth"][src:src + 1]).to(DEV)
            got = warp_points_nerf(
                torch.from_numpy(pts).to(DEV), depth, K,
                poses[src:src + 1, :3, :3], poses[src:src + 1, :3, 3:],
                poses[dst:dst + 1, :3, :3], poses[dst:dst + 1, :3, 3:])
            worst = max(worst, float(np.abs(got[0].cpu().numpy()
                                            - truth).max()))
        scenes[name] = scene
    if not worst < NERF_REPROJ_TOL:
        raise AssertionError(f"[nerf-scenes] reprojection {worst} px from "
                             "the analytic projection")
    log(f"[nerf-scenes] {len(NERF_SCENES)} procedural box rooms, "
        f"{NERF_SHAPE[0]}x{NERF_SHAPE[1]}, fov {NERF_FOV}, "
        f"{NERF_FRAMES['training']} training + {NERF_FRAMES['validation']} "
        f"validation frames each, made and written in "
        f"{time.perf_counter() - t0:.2f} s; warp_points_nerf on the card "
        f"within {worst:.3e} px of the analytic projection on "
        f"{NERF_REPROJ_POINTS} seeded pixels per scene away from depth edges")
    return scenes


def label_agreement(scene: dict, labels: dict, pairs):
    """(fused labels of frame j that reproject within NERF_MATCH_PX of a
    label of frame k, labels of frame j that land inside frame k) summed
    over ``pairs`` (j, k), through ``warp_points_nerf`` on the card."""
    K = torch.from_numpy(camera_intrinsics(NERF_SHAPE, NERF_FOV)).to(DEV)[None]
    poses = torch.from_numpy(scene["poses"]).to(DEV)
    hits = seen = 0
    for j, k in pairs:
        src, dst = labels[j], labels[k]
        if not len(src) or not len(dst):
            continue
        warped = warp_points_nerf(
            torch.from_numpy(src).float().to(DEV),
            torch.from_numpy(scene["depth"][j:j + 1]).to(DEV), K,
            poses[j:j + 1, :3, :3], poses[j:j + 1, :3, 3:],
            poses[k:k + 1, :3, :3], poses[k:k + 1, :3, 3:])[0]
        inside = ((warped >= 0) & (warped < torch.tensor(
            NERF_SHAPE, device=DEV))).all(-1)
        dist = torch.cdist(warped[inside],
                           torch.from_numpy(dst).float().to(DEV))
        hits += int((dist.min(-1).values <= NERF_MATCH_PX).sum())
        seen += int(inside.sum())
    return hits, seen


def phase_nerf_export(root: Path, scenes: dict):
    """Drive ``tasks.export_nerf.export_nerf_labels`` at magicpoint_NeRF
    _export.yaml over both scenes and both splits (the demo MagicPoint,
    after a warm-up on a scratch experiment): frames/s, labels per frame,
    and how many fused labels of each training frame reproject onto a
    label of the next frame within NERF_MATCH_PX. Returns the model."""
    settings.EXPER_PATH = root / "exper"
    model = restored_model(nerf_export_config(NERF_SCENES[0]))
    warm = nerf_export_config(NERF_SCENES[0])
    warm["data"]["experiment_name"] = "warm_up"
    export_nerf.export_nerf_labels(warm, model, seed=SEED, split="validation",
                                   device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {}
    for name in NERF_SCENES:
        for split in ("training", "validation"):
            out[name, split] = export_nerf.export_nerf_labels(
                nerf_export_config(name), model, seed=SEED, split=split,
                device=DEV)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, hits, seen = [], 0, 0
    for (name, split), out_dir in out.items():
        n = len(scenes[name]["splits"][split])
        labels = {}
        for j in range(n):
            pts = np.load(out_dir / f"{j}.npy")
            if (pts.dtype != np.int64 or pts.ndim != 2 or pts.shape[1] != 2
                    or (pts < 0).any() or (pts >= NERF_SHAPE).any()):
                raise AssertionError(f"[nerf-export] {name} {split} {j}: "
                                     f"{pts.dtype} {pts.shape}")
            labels[j] = pts
            counts.append(len(pts))
        if split == "training":
            h, s_ = label_agreement(scenes[name], labels,
                                    [(j, j + 1) for j in range(n - 1)])
            hits, seen = hits + h, seen + s_
    if min(counts) == 0:
        raise AssertionError(f"[nerf-export] a frame without labels: {counts}")
    frames = len(counts)
    log(f"[nerf-export] magicpoint_NeRF_export.yaml (cuts: "
        f"{json.dumps(NERF_EXPORT_CUTS)}; the procedural scenes) at "
        f"{NERF_SHAPE[0]}x{NERF_SHAPE[1]}, batch "
        f"{NERF_EXPORT_CONFIG['data']['batch_size']}: {frames} frames in "
        f"{secs:.4f} s = {frames / secs:.2f} frames/s; labels per frame "
        f"min {min(counts)}, median {statistics.median(counts)}, max "
        f"{max(counts)}; {hits} of {seen} fused training labels that land "
        f"in the next frame lie within {NERF_MATCH_PX} px of one of its "
        f"labels ({hits / max(seen, 1):.3f})")
    return model


def phase_nerf_export_split(model, reps: int = 3):
    """One export batch (the first scene's 16 training frames) split into
    its parts, medians of ``reps`` after a warm-up: the forward, NMS +
    top-k, fusion + NMS of the 16 targets (CUDA events) and the host's
    label writes (host clock)."""
    config = nerf_export_config(NERF_SCENES[0])
    det = config["model"]["detector_head"]
    ds_cfg = dict(config["data"], has_labels=False, warped_pair=False)
    batch = next(iter(DataLoader(NeRFDataset(ds_cfg, "training"), 16,
                                 drop_last=False)))
    on = lambda k: torch.from_numpy(batch[k]).to(DEV)  # noqa: E731
    images = on("image")
    geometry = [on(k) for k in ("depth", "intrinsics", "rotation",
                                "translation")]
    prob_fn = export.make_prob_fn(model, fast=False)
    names = ("forward", "nms_topk", "fusion_nms")
    times = {n: [] for n in (*names, "writes")}

    def run(rep, tmp):
        """One batch: (CUDA events around its device parts, host ms of
        its writes)."""
        rng = np.random.default_rng(rep)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        marks[0].record()
        probs = prob_fn(images)
        marks[1].record()
        pts, valid = export_nerf.detections(probs, det)
        marks[2].record()
        fused = [export_nerf.fuse_and_nms(
            probs, pts, valid, *geometry, j,
            export_nerf.fusion_subset(rng, len(images), j), det)
            for j in range(len(images))]
        marks[3].record()
        marks[3].synchronize()
        t0 = time.perf_counter()
        for j, nms_prob in enumerate(fused):
            np.save(Path(tmp, f"{j}.npy"), export._nms_threshold_points(
                nms_prob.cpu().numpy(), det["det_thresh"]))
        return marks, (time.perf_counter() - t0) * 1e3

    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(reps + 1):
            marks, write_ms = run(rep, tmp)
            if rep == 0:
                continue
            for n, a, z in zip(names, marks[:-1], marks[1:]):
                times[n].append(a.elapsed_time(z))
            times["writes"].append(write_ms)
        busy, span = device_busy(lambda: run(reps + 1, tmp))
    med = {n: statistics.median(v) for n, v in times.items()}
    log(f"[nerf-export-split] one batch of 16 at {NERF_SHAPE[0]}x"
        f"{NERF_SHAPE[1]}: {sum(med.values()):.3f} ms (medians of {reps}) = "
        + " + ".join(f"{n} {med[n]:.3f}" for n in (*names, "writes"))
        + " (fusion + NMS: 16 targets of 12 sources; writes: host clock, "
        "the copies of the NMS'd maps included); one more batch under "
        f"torch.profiler: the card busy {busy:.3f} of {span:.3f} ms, idle "
        f"share at most {1 - busy / span:.3f}")
    return med


def device_busy(fn):
    """(ms the card spent in kernels and copies, ms between CUDA events
    around the call) of one call of ``fn`` under ``torch.profiler``. The
    profiler may drop records of short kernels, so the busy time is a
    lower bound and 1 - busy / span an upper bound of the idle share."""
    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()) / 1e3
    return busy, start.elapsed_time(end)


def nerf_train_config() -> dict:
    return _cut(NERF_TRAIN_CONFIG, NERF_CUTS)


def phase_nerf_train(root: Path):
    """Drive tasks.train_task.train(..., nerf_loss=True, train_nerf=True)
    at superpoint_NeRF_train.yaml with NERF_CUTS over the two scenes and
    the labels [nerf-export] wrote; the launch counters at 0 before the
    20-step run. Returns (its launch counts, the trained state, the
    operands of its last step's descriptor-loss call)."""
    settings.CKPT_PATH = root / "ckpts"
    demo = Path(__file__).resolve().parent / "demo" / "pretrained"
    (settings.CKPT_PATH / "pretrained").mkdir(parents=True)
    (settings.CKPT_PATH / "pretrained" / "demo_mp_5000.ckpt").write_bytes(
        (demo / "demo_mp_5000.ckpt").read_bytes())
    config = nerf_train_config()
    warm = dict(copy.deepcopy(config), ckpt_name="warm_up")
    warm["train"]["num_iters"] = 3
    train_task.train(warm, nerf_loss=True, train_nerf=True, seed=SEED,
                     device=DEV)
    torch.cuda.synchronize()

    hinge_calls = []
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    with recorded_hinge_calls(hinge_calls):
        state = train_task.train(config, validate_training=True,
                                 nerf_loss=True, train_nerf=True, seed=SEED,
                                 device=DEV)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    steps = config["train"]["num_iters"]
    n_val = config["train"]["val_batches"]
    name = config["ckpt_name"]
    if state.iteration != steps:
        raise AssertionError(f"nerf-train: {state.iteration} steps of {steps}")
    expect = {"desc_loss[fwd]": steps + n_val, "desc_loss[dA]": steps,
              "desc_loss[dB]": steps}
    got = {k: v for k, v in counts.items() if k.startswith("desc_loss")}
    if got != expect:
        raise AssertionError(f"nerf-train: launches {got}, expected {expect}")
    metrics = read_metrics(name)
    for tag, rows in metrics.items():
        if not all(np.isfinite(v) for _, v in rows):
            raise AssertionError(f"nerf-train: {tag} is not finite: {rows}")
    losses = metrics["iter_loss/loss"]
    if [s_ for s_, _ in losses] != [5, 10, 15, 20]:
        raise AssertionError(f"nerf-train: loss logged at {losses}")
    pos = metrics["iter_loss/positive_dist"]
    if not all(v > 0 for _, v in pos):
        raise AssertionError(f"nerf-train: no positive pairs: {pos}")
    ckpt = Path(settings.CKPT_PATH, name, f"{name}_{steps}.ckpt")
    saved = loop.load_checkpoint(ckpt)
    if saved["iteration"] != steps:
        raise AssertionError("nerf-train: bad checkpoint")
    rates = [v for _, v in metrics["perf/steps_per_sec"]]
    log(f"[nerf-train] superpoint_NeRF_train.yaml (cuts: "
        f"{json.dumps(NERF_CUTS)}) at {NERF_SHAPE[0]}x{NERF_SHAPE[1]}, batch "
        f"{config['data']['batch_size']}, pairs of real views reprojected "
        f"through depth: {steps} steps + validation of {n_val} batches + "
        f"checkpoint in {secs:.4f} s; steps/s per window of 5 steps: "
        f"{', '.join(f'{r:.2f}' for r in rates)}; loss "
        f"{', '.join(f'{s_}: {v:.4f}' for s_, v in losses)}; descriptor "
        f"loss {metrics['iter_loss/descriptor_loss'][-1][1]:.6f}, positive "
        f"{pos[-1][1]:.6f}; val loss {metrics['val/val_loss'][0][1]:.4f} "
        f"precision {metrics['val/precision'][0][1]:.4f} recall "
        f"{metrics['val/recall'][0][1]:.4f}")
    log(f"[nerf-train] launches: {json.dumps(counts, sort_keys=True)}")
    return counts, state, hinge_calls[steps - 1]


def phase_nerf_train_split(state, reps: int = 5):
    """One NeRF training step split into its parts by CUDA events (medians
    of ``reps`` real steps on the trained state, after a warm-up):
    photometric augmentation of both views, pair preparation (keypoints
    reprojected, heatmaps), the two forwards, the losses (the cells
    reprojected, rows 10-11), the backward, Adam."""
    config = nerf_train_config()
    cfg = train_task.build_step_config(config, include_mask=True,
                                       nerf_desc=True)
    gens = loop.StepGenerators(SEED, DEV)
    loader = get_nerf_loaders(config)["train"][0]
    batch = train_task._to_device(next(iter(loader)), DEV)
    model, opt = state.model, state.optimizer
    names = ("augmentation", "pair_prep", "forwards", "losses", "backward",
             "adam")

    def step(rep, marks):
        gens.reseed(3, rep)
        marks[0].record()
        with torch.no_grad():
            b = dict(batch)
            b["image"] = loop.photometric_augment(
                gens.cpu, batch["image"], cfg.photometric, gens.device)
            b["image_warp"] = loop.photometric_augment(
                gens.cpu, batch["image_warp"], cfg.photometric, gens.device)
            marks[1].record()
            data = prepare_nerf_batch(b)
            noise = [loop._noise(gens, data[v]["image"], cfg.grid_size)
                     for v in ("raw", "warp")]
        marks[2].record()
        opt.zero_grad(set_to_none=True)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            model.train()
            out = model(data["raw"]["image"])
            warped_out = model(data["warp"]["image"])
            marks[3].record()
            det = detector_loss(noise[0], out["logits"],
                                data["raw"]["kpts_heatmap"],
                                data["raw"]["valid_mask"], cfg.grid_size)
            det_w = detector_loss(noise[1], warped_out["logits"],
                                  data["warp"]["kpts_heatmap"],
                                  data["warp"]["valid_mask"], cfg.grid_size)
            _, Hc, Wc, _ = out["desc_raw"].shape
            cells = cell_grid_coords(Hc, Wc, cfg.grid_size, device=DEV)
            wcells = warp_points_nerf(
                cells, data["raw"]["depth"], data["intrinsics"],
                data["raw"]["rotation"], data["raw"]["translation"],
                data["warp"]["rotation"], data["warp"]["translation"])
            desc, _, _ = dl.descriptor_loss_blockwise(
                out["desc_raw"], warped_out["desc_raw"], wcells,
                cfg.desc_cfg, data["warp"]["valid_mask"])
            loss = det + det_w + desc
            marks[4].record()
            loss.backward()
        marks[5].record()
        opt.step()
        marks[6].record()
        marks[6].synchronize()
        return loss

    events = lambda: [torch.cuda.Event(enable_timing=True)  # noqa: E731
                      for _ in range(7)]
    times = {n: [] for n in names}
    whole = []
    for rep in range(reps + 1):
        marks = events()
        loss = step(rep, marks)
        if rep == 0:
            continue  # warm-up
        for n, a, z in zip(names, marks[:-1], marks[1:]):
            times[n].append(a.elapsed_time(z))
        whole.append(marks[0].elapsed_time(marks[6]))
    busy, span = device_busy(lambda: step(reps + 1, events()))
    med = {n: statistics.median(v) for n, v in times.items()}
    log(f"[nerf-train-split] one NeRF step of batch 2 at {NERF_SHAPE[0]}x"
        f"{NERF_SHAPE[1]}: {statistics.median(whole):.3f} ms (median of "
        f"{reps}) = " + " + ".join(f"{n} {med[n]:.3f}" for n in names)
        + f"; last loss {float(loss.detach()):.4f}; one more step under "
        f"torch.profiler: the card busy {busy:.3f} of {span:.3f} ms, idle "
        f"share at most {1 - busy / span:.3f}")
    return med


def nerf_hinge_cases(step_call):
    """The NeRF step's recorded descriptor-loss operands, and the same
    with 64 non-finite and 64 far-off warped cells a sample."""
    A, Bm, wcells, *rest = step_call
    planted = plant_bad_cells(wcells, 64, SEED + 41)
    return [("NeRF step", step_call),
            ("NeRF step, 64 non-finite + 64 far-off cells",
             (A, Bm, planted, *rest))]


def phase_nerf_small():
    """One NeRF step (vgg 8,8,16,16,32,32,32,32, heads 32, 2 pairs of the
    procedural scene at 64 x 80, photometric draws made on the CPU) on the
    card with rows 10-11 and on the CPU plain path from the same weights:
    augmented images within SMALL_IMAGE_ATOL, heatmaps equal, losses within
    SMALL_LOSS_RTOL. Then one fused frame (the demo MagicPoint, 2 frames):
    heatmaps within HP_SMALL_TOL, and the fusion fed the CPU's detections
    within HP_SMALL_TOL, its labels equal away from the threshold and NMS
    near-ties."""
    H, W = NERF_SMALL_SHAPE
    config = nerf_train_config()
    config["model"].update(vgg_cn=[8, 8, 16, 16, 32, 32, 32, 32])
    config["model"]["detector_head"]["detector_dim"] = [32, 32]
    config["model"]["descriptor_head"]["descriptor_dim"] = [32, 32]
    config["data"]["augmentation"]["photometric"]["params"][
        "additive_shade"]["kernel_size_range"] = [9, 15]
    cfg = train_task.build_step_config(config, include_mask=True,
                                       nerf_desc=True)
    scene = box_room(SEED + 42, shape=(H, W))
    src, dst = [0, 3], [1, 4]
    rng = np.random.default_rng(SEED + 43)
    poses = scene["poses"]
    host = {"image": scene["rgb"][src], "image_warp": scene["rgb"][dst],
            "depth": scene["depth"][src],
            "rotation": poses[src, :3, :3], "translation": poses[src, :3, 3:],
            "rotation_warp": poses[dst, :3, :3],
            "translation_warp": poses[dst, :3, 3:],
            "intrinsics": np.stack([camera_intrinsics((H, W), NERF_FOV)] * 2),
            "kpts": rng.uniform(0, [H, W], (2, 60, 2)).astype(np.float32),
            "kpts_mask": np.ones((2, 60), bool)}
    gen = torch.Generator().manual_seed(SEED + 44)
    draws = [draw_photometric_randoms(gen, 2, H, W, cfg.photometric)
             for _ in range(2)]
    noise = [detector_noise(gen, (2, H // 8, W // 8, 65)) for _ in range(2)]
    mcfg = SuperPointConfig.from_dict(config["model"])
    out = {}
    before = _build.launch_counts.copy()
    for dev in ("cpu", DEV):
        to = lambda t: t.to(dev)  # noqa: E731
        batch = {k: to(torch.from_numpy(v)) for k, v in host.items()}
        moved = [{k: ({f: to(t) for f, t in v.items()}
                      if isinstance(v, dict) else v)
                  for k, v in d.items()} for d in draws]
        with torch.no_grad():
            batch["image"] = photometric_from_draws(batch["image"], moved[0],
                                                    cfg.photometric)
            batch["image_warp"] = photometric_from_draws(
                batch["image_warp"], moved[1], cfg.photometric)
            data = prepare_nerf_batch(batch)
        model = init_superpoint(SEED + 45, mcfg, device=dev)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            loss, metrics = loop.superpoint_loss_fn(
                model, data, [to(n) for n in noise], cfg.grid_size, True,
                cfg.desc_cfg, True, True, True)
            loss.backward()
        out[dev] = (data, {k: float(v.detach()) for k, v in metrics.items()})
    launched = _build.launch_counts - before
    if launched != {"desc_loss[fwd]": 1, "desc_loss[dA]": 1,
                    "desc_loss[dB]": 1}:
        raise AssertionError(f"nerf-small: launches {dict(launched)}")
    img_err = 0.0
    for view in ("raw", "warp"):
        img_err = max(img_err, float((out[DEV][0][view]["image"].cpu()
                                      - out["cpu"][0][view]["image"])
                                     .abs().max()))
        if not torch.equal(out[DEV][0][view]["kpts_heatmap"].cpu(),
                           out["cpu"][0][view]["kpts_heatmap"]):
            raise AssertionError(f"nerf-small: {view} heatmaps differ")
    if img_err > SMALL_IMAGE_ATOL:
        raise AssertionError(f"nerf-small: images differ by {img_err}")
    loss_err = 0.0
    for key, want in out["cpu"][1].items():
        rel = abs(out[DEV][1][key] - want) / abs(want)
        loss_err = max(loss_err, rel)
        if not rel <= SMALL_LOSS_RTOL:
            raise AssertionError(f"nerf-small: {key} {out[DEV][1][key]} on "
                                 f"the card, {want} on the CPU")

    # one fused frame of 2, on the card and on the CPU
    ex = nerf_export_config("small")
    det = ex["model"]["detector_head"]
    model = restored_model(ex)
    cpu_model = copy.deepcopy(model).cpu()
    frames = [1, 2]
    fr = {"image": scene["rgb"][frames], "depth": scene["depth"][frames],
          "intrinsics": host["intrinsics"], "rotation": poses[frames, :3, :3],
          "translation": poses[frames, :3, 3:]}
    res = {}
    for dev, m in (("cpu", cpu_model), (DEV, model)):
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in fr.items()}
        probs = export.make_prob_fn(m, fast=False)(t["image"])
        res[dev] = (t, probs, export_nerf.detections(probs, det))
    cpu_pts, cpu_valid = res["cpu"][2]
    prob_err = float((res[DEV][1].cpu() - res["cpu"][1]).abs().max())
    fused, labels = {}, {}
    for dev in ("cpu", DEV):
        t, probs, _ = res[dev]
        geometry = [t[k] for k in ("depth", "intrinsics", "rotation",
                                   "translation")]
        args = (probs, cpu_pts.to(dev), cpu_valid.to(dev), *geometry, 0,
                np.array([False, True]))
        fused[dev] = fuse_nerf_labels(*args).cpu()
        labels[dev] = {tuple(p) for p in export._nms_threshold_points(
            export_nerf.fuse_and_nms(*args, det).cpu().numpy(),
            det["det_thresh"])}
    fuse_err = float((fused[DEV] - fused["cpu"]).abs().max())
    if prob_err > HP_SMALL_TOL or fuse_err > HP_SMALL_TOL:
        raise AssertionError(f"nerf-small: heatmaps {prob_err}, fused "
                             f"{fuse_err}")
    dense = fused["cpu"].numpy()
    for y, x in labels[DEV] ^ labels["cpu"]:
        win = dense[max(y - 3, 0):y + 4, max(x - 3, 0):x + 4]
        near_tie = np.sort(np.abs(win - dense[y, x]).ravel())[1]
        if abs(dense[y, x] - det["det_thresh"]) > HP_SMALL_TOL \
                and near_tie > HP_SMALL_TOL:
            raise AssertionError(f"nerf-small: label ({y}, {x}) on one side")
    log(f"[nerf-small] one NeRF step of 2x{H}x{W}, card (rows 10-11) against "
        f"the CPU plain path: augmented images within {img_err:.3e}, "
        f"heatmaps equal, losses within {loss_err:.3e} relative; one fused "
        f"frame of 2 from the demo MagicPoint: heatmaps within "
        f"{prob_err:.3e}, fusion within {fuse_err:.3e}, "
        f"{len(labels['cpu'])} labels, "
        f"{len(labels[DEV] ^ labels['cpu'])} on one side only")


# ------------------------------------------------------ NeRF scene pipeline

# the in-framework scene pipeline (models/nerf.py, tasks/nerf_task.py,
# models/hash_nerf.py, tools/process_scene.py) at the classic NeRF's full
# width, NeRFConfig(): 8 x 256, skip at 4, 10 and 4 frequencies, 64 + 128
# samples, float32; trained on box-room scene 0 ([nerf-export]'s
# BoxRoomA): its 16 training frames at 480 x 640, gray replicated to RGB,
# K from fov 44, near and far around the room's analytic depth range.
# Cut: as many steps as fit NERF_FIELD_SECONDS (a real scene trains 20,000;
# 40 s until the script's time went to [demo])
NERF_FIELD_SECONDS = 25.0
NERF_FIELD_BATCH = 1024
NERF_FIELD_LR = 5e-4
NERF_FIELD_LOG_EVERY = 100
NERF_DEPTH_CLOSE = 0.05  # m: the share of pixels within 5 cm of the truth
NERF_FIELD_SCENE = "BoxRoomField"
PROCESS_SCENE_ARGS = ["--scene-name", "BoxRoomTool", "--train-iters", "24",
                      "--render-size", "120", "160", "--n-novel-views", "5",
                      "--nerf-preset", "tiny"]
HASH_RAYS = 65536
HASH_STEPS = 50
HASH_BATCH = 8192
HASH_LR = 1e-2
# card against CPU at full width, weights from the port's seeded init:
# renders of 512 rays within tests/test_torch_nerf_model.py's full-width
# RENDER_TOL (rgb, acc, depth); one step of 128 rays within
# tests/test_torch_nerf_scene.py's FULL_STEP_TOL (losses' relative
# tolerance; Adam's first moment on the tensors off sample_pdf's gradient
# path, norm-relative; parameters within 1e-6 where that moment is above
# the given share of its largest); the hash render as
# tests/test_torch_hash_nerf.py holds it (rgb and acc within 1e-6, depth
# within 2e-5)
NERF_SCENE_SMALL_RAYS = 512
NERF_SCENE_SMALL_STEP_RAYS = 128
NERF_SCENE_SMALL_TOL = {"float32": (1e-3, 2e-3, 5e-3),
                        "bfloat16": (1e-2, 1e-2, 3e-2)}
NERF_SCENE_STEP_TOL = {"float32": (1e-4, 0.1, 0.1),
                       "bfloat16": (1e-3, 0.2, 0.1)}
HASH_SMALL_TOL = (1e-6, 1e-6, 2e-5)


def nerf_mlp_macs(cfg: NeRFConfig) -> int:
    """Multiply-adds of one NeRFMLP evaluation (one sample)."""
    pos, dirs = 3 + 6 * cfg.pos_freqs, 3 + 6 * cfg.dir_freqs
    macs, fan_in = 0, pos
    for i in range(cfg.depth):
        macs += fan_in * cfg.width
        fan_in = cfg.width + (pos if i + 1 == cfg.skip_layer else 0)
    return (macs + fan_in * (1 + cfg.width)
            + (cfg.width + dirs) * (cfg.width // 2) + (cfg.width // 2) * 3)


def nerf_ray_flops(cfg: NeRFConfig) -> int:
    """Forward operations of one ray: the coarse MLP on n_coarse samples,
    the fine one on n_coarse + n_fine."""
    return 2 * nerf_mlp_macs(cfg) * (2 * cfg.n_coarse + cfg.n_fine)


def nerf_field_config(scene: dict, **kw) -> NeRFConfig:
    """NeRFConfig() with near and far around the scene's depth range."""
    near = round(float(np.floor(float(scene["depth"].min()) * 90)) / 100, 2)
    far = round(float(np.ceil(float(scene["depth"].max()) * 105)) / 100, 2)
    return NeRFConfig(near=near, far=far, **kw)


def nerf_scene_inputs(scene: dict):
    """(images (16, H, W, 3), poses, K) of the scene's training frames."""
    train = scene["splits"]["training"]
    return (np.repeat(scene["rgb"][train], 3, axis=-1),
            scene["poses"][train], camera_intrinsics(NERF_SHAPE, NERF_FOV))


def nerf_step_split(pool, cfg: NeRFConfig, reps: int = 5):
    """One training step of NERF_FIELD_BATCH rays split by CUDA events
    (medians of ``reps`` after a warm-up) into ray sampling and the coarse
    encoding, the coarse MLP, the coarse composite + sample_pdf + sort,
    the fine encoding and MLP, the fine composite + losses, the backward
    and Adam, on a fresh field; then the card's busy time over 5 steps
    under ``torch.profiler``."""
    model = init_nerf(SEED + 1, cfg, DEV)
    optimizer = create_nerf_optimizer(model, NERF_FIELD_LR)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    all_o, all_d, all_rgb = pool
    B = NERF_FIELD_BATCH
    names = ("sampling", "coarse", "pdf", "fine", "composite", "backward",
             "adam")
    rows = []
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        ev[0].record()
        optimizer.zero_grad(set_to_none=True)
        idx = torch.randint(0, all_o.shape[0], (B,), generator=gen,
                            device=DEV)
        o, d, target = all_o[idx], all_d[idx], all_rgb[idx]
        u_c, u_f = draw_ray_uniforms(B, cfg, gen, DEV)
        t_c = stratified_samples(cfg.n_coarse, cfg.near, cfg.far, (B,),
                                 u=u_c, device=DEV)
        dir_enc = positional_encoding(d, cfg.dir_freqs)
        pos_c = encode_ray_points(o, d, t_c, cfg.pos_freqs)
        ev[1].record()
        sig_c, rgb_c = model.encoded(pos_c, dir_enc[:, None, :].expand(
            pos_c.shape[:-1] + (dir_enc.shape[-1],)), "coarse")
        ev[2].record()
        w_c = render_weights(sig_c, t_c)
        color_c = composite(w_c, rgb_c, t_c)[0]
        edges = torch.cat([t_c[..., :1], 0.5 * (t_c[..., 1:] + t_c[..., :-1]),
                           t_c[..., -1:]], dim=-1)
        t_all = torch.sort(torch.cat([t_c, sample_pdf(
            edges, w_c, cfg.n_fine, u=u_f)], dim=-1), dim=-1).values
        ev[3].record()
        pos_f = encode_ray_points(o, d, t_all, cfg.pos_freqs)
        sig_f, rgb_f = model.encoded(pos_f, dir_enc[:, None, :].expand(
            pos_f.shape[:-1] + (dir_enc.shape[-1],)), "fine")
        ev[4].record()
        color_f = composite(render_weights(sig_f, t_all), rgb_f, t_all)[0]
        loss = (torch.mean((color_c - target) ** 2)
                + torch.mean((color_f - target) ** 2))
        ev[5].record()
        loss.backward()
        ev[6].record()
        optimizer.step()
        ev[7].record()
        ev[7].synchronize()
        if rep:
            rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(7)])
    split = {n: statistics.median(r[i] for r in rows)
             for i, n in enumerate(names)}
    busy, span = device_busy(lambda: nerf_train_steps(
        model, optimizer, pool, cfg, B, 5, gen))
    return split, busy, span


def phase_nerf_field(scene: dict, peaks):
    """[nerf-scene]: ``train_nerf_scene`` at full width on the scene's
    training frames (a 20-step probe sets the step count that fits
    NERF_FIELD_SECONDS): ms per step, rays/s, the loss history and one
    step split. Raises unless the last logged loss is below the first.
    Returns (the trained field, its config, the ray pool)."""
    images, poses, K = nerf_scene_inputs(scene)
    cfg = nerf_field_config(scene)
    kw = dict(ray_batch=NERF_FIELD_BATCH, learning_rate=NERF_FIELD_LR,
              seed=SEED, device=DEV)
    train_nerf_scene(images, poses, K, cfg, num_iters=5, log_every=5, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_nerf_scene(images, poses, K, cfg, num_iters=20, log_every=20, **kw)
    torch.cuda.synchronize()
    probe = (time.perf_counter() - t0) / 20
    steps = max(2, int(NERF_FIELD_SECONDS / probe) // NERF_FIELD_LOG_EVERY
                ) * NERF_FIELD_LOG_EVERY
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, history = train_nerf_scene(images, poses, K, cfg,
                                      num_iters=steps,
                                      log_every=NERF_FIELD_LOG_EVERY, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not all(np.isfinite(history)) or not history[-1] < history[0]:
        raise AssertionError(f"[nerf-scene] the loss did not fall: {history}")
    pool = scene_rays(images, poses, K, DEV)
    split, busy, span = nerf_step_split(pool, cfg)
    ms = secs * 1e3 / steps
    bound = 3 * NERF_FIELD_BATCH * nerf_ray_flops(cfg) / peaks[2] * 1e3
    log(f"[nerf-scene] train_nerf_scene at {cfg.depth} x {cfg.width} ("
        f"{cfg.n_coarse} + {cfg.n_fine} samples, near {cfg.near}, far "
        f"{cfg.far}, float32) on {len(images)} box-room frames of "
        f"{NERF_SHAPE[0]}x{NERF_SHAPE[1]}, batch {NERF_FIELD_BATCH}, lr "
        f"{NERF_FIELD_LR}; cut: {steps} steps (those that fit "
        f"{NERF_FIELD_SECONDS:.0f} s at the 20-step probe's "
        f"{probe * 1e3:.3f} ms) of a scene's 20,000: {secs:.3f} s, "
        f"{ms:.4f} ms/step = {steps * NERF_FIELD_BATCH / secs:.1f} rays/s "
        f"against a float32 bound of {bound:.4f} ms/step (3 x "
        f"{nerf_ray_flops(cfg) / 1e6:.2f} MFLOP a ray at "
        f"{peaks[2] / 1e12:.0f} TFLOP/s); loss every "
        f"{NERF_FIELD_LOG_EVERY} steps "
        f"{json.dumps([round(h, 6) for h in history])}")
    log(f"[nerf-scene-split] one step (CUDA events, median of 5): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f" = {sum(split.values()):.4f} ms; 5 steps: the card busy "
        f"{busy:.3f} of {span:.3f} ms (idle at most "
        f"{1 - busy / span:.3f})")
    return model, cfg, pool


def depth_errors(depth: np.ndarray, truth: np.ndarray):
    err = np.abs(depth - truth)
    return float(np.median(err)), float(np.mean(err < NERF_DEPTH_CLOSE))


def phase_nerf_render(model, cfg: NeRFConfig, scene: dict, peaks):
    """[nerf-render]: ``render_dataset`` of the scene's 4 validation poses
    at 480 x 640 (ms per frame and rays/s against the float32 bound), the
    rendered depth against the box room's exact depth beside the untrained
    field's (``init_nerf`` of the same seed; raises unless the trained
    median is lower), then the demo MagicPoint's labels of the rendered
    frames through ``export_nerf_labels``."""
    val = scene["splits"]["validation"]
    poses, K = scene["poses"][val], camera_intrinsics(NERF_SHAPE, NERF_FOV)
    splits = {"validation": list(range(len(val)))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    root = render_dataset(model, NERF_FIELD_SCENE, poses, NERF_SHAPE, K, cfg,
                          splits, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    depth = np.stack([np.load(root / "depth" / "validation" / f"{j}.npy")
                      for j in splits["validation"]])
    truth = scene["depth"][val]
    untrained = init_nerf(SEED, cfg, DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    raw = np.stack([render_image(untrained, NERF_SHAPE, K, p, cfg,
                                 generator=gen, device=DEV)["depth"].cpu()
                    .numpy() for p in poses])
    med, close = depth_errors(depth, truth)
    raw_med, raw_close = depth_errors(raw, truth)
    if not np.isfinite(depth).all() or not med < raw_med:
        raise AssertionError(f"[nerf-render] depth error {med} m, untrained "
                             f"{raw_med} m")
    config = nerf_export_config(NERF_FIELD_SCENE)
    out_dir = export_nerf.export_nerf_labels(config, restored_model(config),
                                             seed=SEED, split="validation",
                                             device=DEV)
    labels = [np.load(out_dir / f"{j}.npy") for j in splits["validation"]]
    for pts in labels:
        if (pts.dtype != np.int64 or pts.ndim != 2 or pts.shape[1] != 2
                or (pts < 0).any() or (pts >= NERF_SHAPE).any()):
            raise AssertionError(f"[nerf-render] labels {pts.dtype} "
                                 f"{pts.shape}")
    n_rays = len(val) * NERF_SHAPE[0] * NERF_SHAPE[1]
    bound = NERF_SHAPE[0] * NERF_SHAPE[1] * nerf_ray_flops(cfg) / peaks[2]
    log(f"[nerf-render] render_dataset of {len(val)} validation poses at "
        f"{NERF_SHAPE[0]}x{NERF_SHAPE[1]} (chunks of 4,096 rays, float32, "
        f"files written): {secs * 1e3 / len(val):.3f} ms/frame = "
        f"{n_rays / secs:.1f} rays/s against a float32 bound of "
        f"{bound * 1e3:.3f} ms/frame ({bound * peaks[2] / 1e12:.2f} TFLOP); "
        f"depth against the exact depth: median {med:.4f} m, "
        f"{close:.4f} of pixels within {NERF_DEPTH_CLOSE} m (untrained "
        f"field: {raw_med:.4f} m, {raw_close:.4f}); labels of the "
        f"rendered frames (demo MagicPoint, export_nerf_labels): "
        f"{[len(x) for x in labels]}")


def phase_process_scene(root: Path, scene: dict):
    """[process-scene]: the scene's training frames as RGB PNGs with a
    NerfStudio ``transforms.json`` through ``tools.process_scene.main`` on
    the card (PROCESS_SCENE_ARGS); the layout checked and read by
    ``NeRFDataset``."""
    scene_dir = root / "process_scene"
    (scene_dir / "images").mkdir(parents=True)
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    frames = []
    for j, i in enumerate(scene["splits"]["training"]):
        name = f"images/frame_{j:05d}.png"
        gray = np.clip(scene["rgb"][i] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        write_rgb(scene_dir / name, np.repeat(gray, 3, axis=-1))
        frames.append({"file_path": name,
                       "transform_matrix": (scene["poses"][i] @ flip).tolist()})
    (scene_dir / "transforms.json").write_text(json.dumps(
        {"camera_angle_x": float(np.deg2rad(NERF_FOV)), "frames": frames}))
    t0 = time.perf_counter()
    out = process_scene.main(["--data-path", str(scene_dir)]
                             + PROCESS_SCENE_ARGS)
    secs = time.perf_counter() - t0
    counts = {}
    for split in ("training", "validation", "test"):
        ds = NeRFDataset({"name": "NeRF", "data_dir": out.name,
                          "warped_pair": False}, split)
        counts[split] = len(ds)
        for i in range(len(ds)):
            sample = ds[i]
            if (sample["image"].shape != (120, 160, 1)
                    or sample["depth"].shape != (120, 160)
                    or not np.isfinite(sample["depth"]).all()):
                raise AssertionError(f"[process-scene] {split} {i}: "
                                     f"{sample['image'].shape}")
    if counts != {"training": 4, "validation": 0, "test": 1}:
        raise AssertionError(f"[process-scene] frames per split {counts}")
    log(f"[process-scene] tools.process_scene.main {' '.join(PROCESS_SCENE_ARGS)}"
        f" on {len(frames)} box-room frames (RGB PNGs, transforms.json) on "
        f"the card: {secs:.3f} s; NeRFDataset reads {counts}")


def phase_hash_nerf(pool, field_cfg: NeRFConfig):
    """[hash-nerf]: HashNeRF at HashNeRFConfig()'s levels, table and
    samples (near and far the field's): one render of HASH_RAYS seeded
    box-room rays, then HASH_STEPS Adam steps on batches of HASH_BATCH of
    them; raises unless the loss falls."""
    cfg = HashNeRFConfig(near=field_cfg.near, far=field_cfg.far)
    model = init_hash_nerf(SEED, cfg, DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    all_o, all_d, all_rgb = pool
    idx = torch.randint(0, all_o.shape[0], (HASH_RAYS,), generator=gen,
                        device=DEV)
    o, d, target = all_o[idx], all_d[idx], all_rgb[idx]
    with torch.no_grad():
        render_rays_hash(model, o[:4096], d[:4096], cfg, generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_rays_hash(model, o, d, cfg, generator=gen)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    if not all(torch.isfinite(v).all() for v in out.values()):
        raise AssertionError("[hash-nerf] non-finite render")
    optimizer = create_nerf_optimizer(model, HASH_LR)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HASH_STEPS):
        b = torch.randint(0, HASH_RAYS, (HASH_BATCH,), generator=gen,
                          device=DEV)
        optimizer.zero_grad(set_to_none=True)
        rgb = render_rays_hash(model, o[b], d[b], cfg, generator=gen)["rgb"]
        loss = torch.mean((rgb - target[b]) ** 2)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = torch.stack(losses).cpu().numpy()
    if not losses[-5:].mean() < losses[:5].mean():
        raise AssertionError(f"[hash-nerf] the loss did not fall: {losses}")
    log(f"[hash-nerf] HashNeRF ({cfg.n_levels} levels, 2^"
        f"{cfg.log2_table_size} entries, {cfg.n_samples} samples, near "
        f"{cfg.near}, far {cfg.far}): one render of {HASH_RAYS} box-room "
        f"rays {render_s * 1e3:.3f} ms = {HASH_RAYS / render_s:.1f} rays/s; "
        f"{HASH_STEPS} Adam steps of {HASH_BATCH} rays (lr {HASH_LR}) "
        f"{train_s * 1e3 / HASH_STEPS:.3f} ms/step = "
        f"{HASH_STEPS * HASH_BATCH / train_s:.1f} rays/s; loss "
        f"{losses[:5].mean():.6f} -> {losses[-5:].mean():.6f} (means of "
        f"the first and last 5)")


def off_sampler(name: str) -> bool:
    """Parameters whose gradient does not pass through ``sample_pdf``'s
    ill-conditioned 1 / (cdf_a - cdf_b): the fine field's, and the coarse
    field's view branch."""
    return name.startswith("fine.") or name.split(".")[1] in (
        "feature", "view1", "rgb")


def step_agreement(models: dict, opts: dict, clear_at: float):
    """(largest norm-relative distance of Adam's first moment, largest
    parameter distance where the CPU's moment is above ``clear_at`` of its
    largest) between the card's and the CPU's field after one step, over
    the off-sampler tensors."""
    mu_err = param_err = 0.0
    for (name, p_cpu), p_card in zip(models["cpu"].named_parameters(),
                                     models[DEV].parameters()):
        if not off_sampler(name):
            continue
        mu = opts["cpu"].state[p_cpu]["exp_avg"]
        got = opts[DEV].state[p_card]["exp_avg"].cpu()
        mu_err = max(mu_err, float((got - mu).norm() / mu.norm()))
        clear = mu.abs() > clear_at * mu.abs().max()
        param_err = max(param_err, float(
            (p_card.detach().cpu() - p_cpu.detach())[clear].abs().max()))
    return mu_err, param_err


def _render_errors(a: dict, b: dict) -> dict:
    return {k: float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a}


def phase_nerf_scene_small():
    """[nerf-scene-small]: the full-width field on the card and on the CPU
    from one seeded init (no JAX) with the same draws: a render of
    NERF_SCENE_SMALL_RAYS rays and one step of NERF_SCENE_SMALL_STEP_RAYS,
    float32 and bf16; then one ``render_rays_hash`` at HashNeRFConfig()."""
    rng = np.random.default_rng(SEED + 50)
    n = NERF_SCENE_SMALL_RAYS
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32))
    d = F.normalize(torch.from_numpy(
        rng.standard_normal((n, 3)).astype(np.float32)), dim=-1)
    target = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    base = NeRFConfig(near=0.5, far=4.5)
    state = init_nerf(SEED + 7, base, device="cpu").state_dict()
    draws = draw_ray_uniforms(n, base, torch.Generator().manual_seed(SEED + 8),
                              "cpu")
    card = lambda t: t.to(DEV)  # noqa: E731
    notes = []
    for dtype in ("float32", "bfloat16"):
        cfg = NeRFConfig(near=0.5, far=4.5, compute_dtype=dtype)
        models = {}
        for dev in ("cpu", DEV):
            models[dev] = NeRF(cfg)
            models[dev].load_state_dict(state)
            models[dev].to(dev)
        with torch.no_grad():
            want = render_rays(models["cpu"], o, d, cfg, draws=draws)
            got = render_rays(models[DEV], card(o), card(d), cfg,
                              draws=tuple(map(card, draws)))
        err = _render_errors(got, want)
        for k, v in err.items():
            tol = NERF_SCENE_SMALL_TOL[dtype][("rgb", "acc", "depth").index(
                k.split("_")[0])]
            if not v <= tol:
                raise AssertionError(f"[nerf-scene-small] {dtype} {k}: {v} "
                                     f"> {tol}")
        m = NERF_SCENE_SMALL_STEP_RAYS
        opts = {dev: create_nerf_optimizer(models[dev], NERF_FIELD_LR)
                for dev in models}
        steps = {dev: nerf_train_step(
            models[dev], opts[dev], o[:m].to(dev), d[:m].to(dev),
            target[:m].to(dev), cfg,
            draws=tuple(u[:m].to(dev) for u in draws)) for dev in models}
        loss_tol, mu_tol, clear_at = NERF_SCENE_STEP_TOL[dtype]
        loss_err = max(abs(float(steps[DEV][k]) / float(steps["cpu"][k]) - 1)
                       for k in steps["cpu"])
        mu_err, param_err = step_agreement(models, opts, clear_at)
        if not (loss_err <= loss_tol and mu_err <= mu_tol
                and param_err <= 1e-6):
            raise AssertionError(f"[nerf-scene-small] {dtype} step: losses "
                                 f"{loss_err}, moment {mu_err}, parameters "
                                 f"{param_err}")
        notes.append(f"{dtype}: render rgb {err['rgb']:.3e}, acc "
                     f"{err['acc']:.3e}, depth {err['depth']:.3e}; step "
                     f"losses {loss_err:.3e} relative, off-sampler moments "
                     f"{mu_err:.3e} (norm-relative), their parameters "
                     f"{param_err:.3e}")
    hcfg = HashNeRFConfig()
    hstate = init_hash_nerf(SEED + 9, hcfg, device="cpu").state_dict()
    u = torch.rand((n, hcfg.n_samples),
                   generator=torch.Generator().manual_seed(SEED + 10))
    outs = {}
    for dev in ("cpu", DEV):
        model = HashNeRF(hcfg)
        model.load_state_dict(hstate)
        with torch.no_grad():
            outs[dev] = render_rays_hash(model.to(dev), o.to(dev), d.to(dev),
                                         hcfg, u=u.to(dev))
    herr = _render_errors(outs[DEV], outs["cpu"])
    for k, tol in zip(("rgb", "acc", "depth"), HASH_SMALL_TOL):
        if not herr[k] <= tol:
            raise AssertionError(f"[nerf-scene-small] hash {k}: {herr[k]}")
    log(f"[nerf-scene-small] NeRFConfig() width on the card against the CPU "
        f"(one seeded init, the same draws; {n} rays rendered, one step of "
        f"{NERF_SCENE_SMALL_STEP_RAYS}): " + "; ".join(notes)
        + f"; render_rays_hash at HashNeRFConfig(): rgb {herr['rgb']:.3e}, "
        f"acc {herr['acc']:.3e}, depth {herr['depth']:.3e}")


def sphere_scene(seed: int, n: int, near=2.0, far=6.0):
    """Rays from a shell of radius 4 toward the unit sphere, coloured by
    its normal on a black background (the analytic scene the committed
    fields were fitted to, benchmarks/nerf_quality_sphere.py); draws from a
    numpy seed. (origins, directions, rgb, depth, hit) float32 on the
    card."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3)).astype(np.float32)
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    aim = 0.25 * rng.standard_normal((n, 3)).astype(np.float32)
    d = aim - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    b = np.sum(o * d, axis=-1)
    disc = b * b - (np.sum(o * o, axis=-1) - 1.0)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    t = np.where((disc > 0) & (t > near) & (t < far), t, far)
    hit = t < far
    p = o + t[:, None] * d
    rgb = np.where(hit[:, None], 0.5 * p + 0.5, 0.0)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in
                 (o.astype(np.float32), d.astype(np.float32),
                  rgb.astype(np.float32), t.astype(np.float32), hit))


def encoded(field, o, d):
    oe, de = encode_rays(o, d, field.A, field.c)
    return oe, de, direction_features(field.params, d, field.A, field.c)


def calibrated_int8(field, oe, de, df):
    """``quantize_field`` of the float32 values of ``field``'s weights,
    calibrated on the first rays given, as tensors on the card."""
    n = INT8_CALIB_RAYS
    qf = rk.quantize_field(
        {k: v.float().cpu().numpy() for k, v in field.params.items()},
        oe[:n].cpu().numpy(), de[:n].cpu().numpy(), df[:n].cpu().numpy(),
        n_samples=field.cfg.n_samples, near=field.cfg.near, far=field.cfg.far)
    return rk.qfield_to(qf, "cuda")


def render_kw(field, **kw):
    """Keywords of the render kernels' wrappers for ``field``."""
    cfg = field.cfg
    return dict(jitter=0.5, n_samples=cfg.n_samples, near=cfg.near,
                far=cfg.far, block=field.block, s_chunk=field.s_chunk, **kw)


def check_render(name, rgb, depth, n, far):
    if tuple(rgb.shape) != (n, 3) or tuple(depth.shape) != (n,):
        raise AssertionError(f"{name}: shapes {tuple(rgb.shape)} "
                             f"{tuple(depth.shape)}")
    if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all()):
        raise AssertionError(f"{name}: non-finite outputs")
    lo, hi = float(depth.min()), float(depth.max())
    if lo < 0.0 or hi > far + 1e-3:
        raise AssertionError(f"{name}: depth in [{lo}, {hi}]")
    if float(rgb.min()) < 0.0 or float(rgb.max()) > 1.0 + 1e-5:
        raise AssertionError(f"{name}: rgb outside [0, 1]")


def phase_render(fields, o, d):
    """The drive of the render path: every variant bench_nerf.py times, 10
    renders each, with the launch counters at 0 before. Returns (launch
    counts, the operands the kernels were given)."""
    f128 = fields[128]
    cfg = f128.cfg
    n = o.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # field-dependent, camera-independent: built once per field
    ivol = field_integral_volume(
        {k: v.float() for k, v in f128.params.items()}, cfg)
    torch.cuda.synchronize()
    ivol_s = time.perf_counter() - t0
    flag_kw = dict(block=f128.block, n_samples=cfg.n_samples,
                   s_chunk=f128.s_chunk, near=cfg.near, far=cfg.far,
                   extent=float(cfg.far))
    cached = chunk_flags(o, d, ivol, **flag_kw)
    res = ivol.shape[0] - 1
    log(f"[render] integral occupancy volume ({res}^3 cells, 2x probes, 32 "
        f"directions) built in {ivol_s:.4f} s: {int(ivol[-1, -1, -1]) / res**3:.4f} "
        f"of the volume occupied; live chunk share of the orbit rays at block "
        f"{f128.block} x {f128.s_chunk} samples: {float(cached.float().mean()):.4f}")
    oe, de, df = encoded(f128, o, d)
    t0 = time.perf_counter()
    qf = calibrated_int8(f128, oe, de, df)
    qops = rk.prepare_render_int8(qf)  # laid out once, as a server would
    log(f"[render] quantize_field on the first {INT8_CALIB_RAYS} rays (numpy "
        f"on the host) and prepare_render_int8: {time.perf_counter() - t0:.4f} s")
    w128 = [f128.params[k] for k in ("w1", "w2", "w3")]

    def rays128(**kw):
        out = render_fused_rays(f128.params, o, d, cfg, A=f128.A, c=f128.c,
                                block=f128.block, s_chunk=f128.s_chunk, **kw)
        return out["rgb"], out["depth"]

    def cached_flags():
        # a fixed camera's flags, built once: only encoding and render
        e = encoded(f128, o, d)
        return rk.render_fused(e[0], e[1], *w128, e[2], **render_kw(
            f128, flags=cached, early_stop_eps=RENDER_EPS))

    def packed(f):
        out = render_fused_rays_packed(
            f.params, o, d, f.cfg, A=f.A, c=f.c, block=f.block,
            s_chunk=f.s_chunk, early_stop_eps=RENDER_EPS)
        return out["rgb"], out["depth"]

    # the same fields with their weights in float32 (render_f32_kernel)
    f32 = {w: {k: v.float() for k, v in f.params.items()}
           for w, f in fields.items()}

    def rays_f32(width):
        f = fields[width]
        fn = render_fused_rays if width == 128 else render_fused_rays_packed
        out = fn(f32[width], o, d, f.cfg, A=f.A, c=f.c, block=f.block,
                 s_chunk=f.s_chunk, early_stop_eps=RENDER_EPS)
        return out["rgb"], out["depth"]

    variants = [
        ("dense", "render[bf16]", lambda: rays128(early_stop_eps=0.0)),
        ("early-stop", "render[bf16]",
         lambda: rays128(early_stop_eps=RENDER_EPS)),
        ("occupancy+early-stop", "render[bf16]",
         lambda: rays128(occupancy_ivol=ivol, early_stop_eps=RENDER_EPS)),
        ("occupancy-cached+early-stop", "render[bf16]", cached_flags),
        ("packed-w64", "render[w64]", lambda: packed(fields[64])),
        ("packed-w32", "render[w32]", lambda: packed(fields[32])),
        ("int8+early-stop", "render[int8]", lambda: rk.render_fused_int8(
            oe, de, qops, df, **render_kw(f128, early_stop_eps=RENDER_EPS))),
        ("f32+early-stop", "render[f32]", lambda: rays_f32(128)),
        ("f32-packed-w64", "render[f32-w64]", lambda: rays_f32(64)),
        ("f32-packed-w32", "render[f32-w32]", lambda: rays_f32(32)),
    ]
    for _, _, fn in variants:  # warm-up: library handles, allocator pools
        fn()
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    for name, _, fn in variants:
        t0 = time.perf_counter()
        for _ in range(RENDER_ITERS):
            rgb, depth = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check_render(name, rgb, depth, n, cfg.far)
        log(f"[render] {name}: {RENDER_ITERS} renders of {n} rays x "
            f"{cfg.n_samples} samples in {secs:.4f} s, "
            f"{n * RENDER_ITERS / secs:.1f} rays/s, "
            f"{secs / RENDER_ITERS * 1e3:.3f} ms per render; mean rgb "
            f"{float(rgb.mean()):.4f}, mean depth {float(depth.mean()):.4f}")
    counts = dict(_build.launch_counts)
    log(f"[render] launches: {json.dumps(counts, sort_keys=True)}")
    expect = collections.Counter()
    for _, key, _ in variants:
        expect[key] += RENDER_ITERS
    if counts != dict(expect):
        raise AssertionError(f"render: launches {counts}, expected one per "
                             f"render: {dict(expect)}")
    return counts, types.SimpleNamespace(o=o, d=d, oe=oe, de=de, df=df,
                                         qf=qf, qops=qops, flags=cached,
                                         ivol=ivol)


def psnr_and_depth_error(rgb, depth, scene):
    """(PSNR of rgb in dB, mean relative error of depth over the rays that
    hit the sphere) against the analytic scene."""
    _, _, rgb_t, t_t, hit = scene
    mse = float(((rgb - rgb_t) ** 2).mean())
    derr = (depth - t_t).abs() / t_t
    return (-10.0 * np.log10(mse),
            float(torch.where(hit, derr, 0.0).mean() / hit.float().mean()))


def phase_render_quality(fields, ivol):
    """Held-out rays of the analytic sphere through each kernel and its
    plain version (on the card, same operands); ``ivol`` is the width-128
    field's integral occupancy volume."""
    scene = sphere_scene(SEED + 12, QUALITY_RAYS)
    o, d = scene[:2]
    scores = {}

    def score(name, out):
        rgb, depth = out
        check_render(name, rgb, depth, QUALITY_RAYS, 6.0)
        scores[name] = psnr_and_depth_error(rgb, depth, scene)
        log(f"[render-quality] {name}: {scores[name][0]:.4f} dB, mean "
            f"surface-depth error {scores[name][1] * 100:.3f}%")

    def within(a, b):
        gap = abs(scores[a][0] - scores[b][0])
        if not gap <= QUALITY_GAP_DB:
            raise AssertionError(f"render-quality: {a} and {b} are {gap:.3f} "
                                 f"dB apart (limit {QUALITY_GAP_DB})")

    for width, f in fields.items():
        oe, de, df = encoded(f, o, d)
        ws = [f.params[k] for k in ("w1", "w2", "w3")]
        kw = render_kw(f, early_stop_eps=RENDER_EPS)
        if width == 128:
            kernel, plain = rk.render_fused, rk.render_fused_plain
        else:
            kw["width"] = width
            kernel, plain = rk.render_fused_packed, rk.render_fused_packed_plain
        score(f"w{width} kernel", kernel(oe, de, *ws, df, **kw))
        score(f"w{width} plain", plain(oe, de, *ws, df, **kw))
        within(f"w{width} kernel", f"w{width} plain")
        if scores[f"w{width} kernel"][0] < QUALITY_MIN_DB:
            raise AssertionError(f"render-quality: w{width} below "
                                 f"{QUALITY_MIN_DB} dB")
    f = fields[128]
    for name, iv in (("dense", None), ("occupancy-skip", ivol)):
        # block 512 x 8 samples, as the reference's quality gate renders
        out = render_fused_rays(f.params, o, d, f.cfg, A=f.A, c=f.c,
                                occupancy_ivol=iv, early_stop_eps=RENDER_EPS)
        score(f"w128 {name} (render_fused_rays)", (out["rgb"], out["depth"]))
    within("w128 dense (render_fused_rays)",
           "w128 occupancy-skip (render_fused_rays)")
    if scores["w128 occupancy-skip (render_fused_rays)"][0] < QUALITY_MIN_DB:
        raise AssertionError("render-quality: occupancy-skip below "
                             f"{QUALITY_MIN_DB} dB")
    oe, de, df = encoded(f, o, d)
    qf = calibrated_int8(f, oe, de, df)
    kw = render_kw(f, early_stop_eps=RENDER_EPS)
    score("int8 kernel", rk.render_fused_int8(oe, de, qf, df, **kw))
    score("int8 plain", rk.render_fused_int8_plain(oe, de, qf, df, **kw))
    within("int8 kernel", "int8 plain")


def phase_render_kernels(fields, ops, peaks):
    """Each render kernel against its plain version on the drive's
    operands; the first case of each kernel gives its row."""
    int8_rate, mem_rate, f32_rate, bf16_rate = peaks
    tf32_rate = bf16_rate / 2  # dense TF32 is half the bf16 rate on Hopper
    f128 = fields[128]
    n = ops.oe.shape[0]
    cases = [("render[bf16]", "dense", f128, dict(early_stop_eps=0.0)),
             ("render[bf16]", "early stop", f128,
              dict(early_stop_eps=RENDER_EPS)),
             ("render[bf16]", "cached flags + early stop", f128,
              dict(flags=ops.flags, early_stop_eps=RENDER_EPS)),
             ("render[w64]", "early stop", fields[64],
              dict(early_stop_eps=RENDER_EPS)),
             ("render[w32]", "early stop", fields[32],
              dict(early_stop_eps=RENDER_EPS)),
             ("render[int8]", "early stop", f128,
              dict(early_stop_eps=RENDER_EPS)),
             ("render[int8]", "dense", f128, dict(early_stop_eps=0.0)),
             ("render[int8]", "cached flags + early stop", f128,
              dict(flags=ops.flags, early_stop_eps=RENDER_EPS)),
             ("render[f32]", "early stop", f128,
              dict(early_stop_eps=RENDER_EPS)),
             ("render[f32-w64]", "early stop", fields[64],
              dict(early_stop_eps=RENDER_EPS)),
             ("render[f32-w32]", "early stop", fields[32],
              dict(early_stop_eps=RENDER_EPS))]
    rows = {}
    for key, label, f, extra in cases:
        f32 = key.startswith("render[f32")
        W = f.width
        kw = render_kw(f, **extra)
        packed = W != 128
        chunk = f.s_chunk * (128 // W if packed else 1)
        if f is f128:
            oe, de, df = ops.oe, ops.de, ops.df
        else:
            # the encodings render_fused_rays_packed hands its kernel
            oe, de, df = encoded(f, ops.o, ops.d)
        if key == "render[int8]":
            weights = [ops.qf[k] for k in ("qw1", "qw2", "qw3", "m1", "m2", "r3")]
            head = rk.int8_mlp_head(ops.qf)
            kernel = lambda: rk.render_fused_int8(oe, de, ops.qops, df, **kw)  # noqa: E731
            rate, unit = int8_rate, "int8"
        else:
            weights = [f.params[k].float() if f32 else f.params[k]
                       for k in ("w1", "w2", "w3")]
            head = rk.float_mlp_head(*weights, packed)
            fn = rk.render_fused_packed if packed else rk.render_fused
            if packed:
                kw["width"] = W
            kernel = lambda: fn(oe, de, *weights, df, **kw)  # noqa: E731
            rate, unit = bf16_rate, "bf16"
        rgb_tol, depth_tol = (RENDER_F32_TOL if f32
                              else (RENDER_RGB_TOL, RENDER_DEPTH_TOL))

        def plain():
            return rk.render_plain_counted(
                oe, de, df, head, width=W, n_samples=kw["n_samples"],
                chunk=chunk, near=kw["near"], far=kw["far"],
                jitter=kw["jitter"], block=kw["block"], flags=kw.get("flags"),
                early_stop_eps=kw["early_stop_eps"], packed=packed)

        before = _build.launch_counts.copy()
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if _build.launch_counts - before != {key: 2}:
            raise AssertionError(f"{key} {label}: launches "
                                 f"{dict(_build.launch_counts - before)}")
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(f"{key} {label}: two runs differ")
        if key == "render[int8]":  # the quantize_field dict, laid out on the call
            by_dict = rk.render_fused_int8(oe, de, ops.qf, df, **kw)
            if not (torch.equal(got[0], by_dict[0]) and torch.equal(got[1], by_dict[1])):
                raise AssertionError(f"{key} {label}: the dict route differs")
        want_rgb, want_depth, composited = plain()
        rgb_err = float((got[0] - want_rgb).abs().max())
        depth_err = float((got[1] - want_depth).abs().max())
        if not (rgb_err <= rgb_tol and depth_err <= depth_tol):
            raise AssertionError(
                f"{key} {label}: rgb differs by {rgb_err}, depth by "
                f"{depth_err} (limits {rgb_tol}, {depth_tol})")
        share = float((got[0] != want_rgb).float().mean())
        ms = cuda_ms(kernel, reps=20, warmup=3)
        plain_ms = cuda_ms(plain, reps=3)
        dev_ms, how = device_ms(kernel, "render")
        # the products of the (ray, sample) pairs this run's flags and early
        # stop leave: two W x W layers and the (W, 4) head that holds sigma
        # and rgb (the TPU kernel's full-width head would make it 3 W^2)
        ops_done = 2 * composited * (2 * W * W + 4 * W)
        moved = nbytes(oe, de, df, *weights, got[0], got[1])
        if kw.get("flags") is not None:
            moved += nbytes(kw["flags"])
        t_ops, t_bytes = ops_done / rate * 1e3, moved / mem_rate * 1e3
        bounds = ""
        if f32:
            # the lower of the float32 CUDA cores and the same float32-grade
            # work as three TF32 passes on the tensor cores (rows 10-11's)
            t_f32, t_tf32 = ops_done / f32_rate * 1e3, 3 * ops_done / tf32_rate * 1e3
            t_ops = min(t_f32, t_tf32)
            bounds = (f"; float32 CUDA cores {t_f32:.4f} ms, three TF32 passes "
                      f"{t_tf32:.4f} ms")
            unit = "float32 | TF32"
        # yardstick, not a library equivalent (no single PyTorch call
        # computes a fused render): the three products alone, bf16 on the
        # tensor cores (float32 with TF32 off for the float32 render), over
        # every (ray, sample) row, activations through device memory
        dtype = torch.float32 if f32 else torch.bfloat16
        x = torch.zeros((n * kw["n_samples"], W), dtype=dtype, device="cuda")
        wb = [w.to(dtype) for w in weights[:3]]
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            matmul_ms = cuda_ms(lambda: ((x @ wb[0]) @ wb[1]) @ wb[2], reps=5)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del x
        log(f"[kernel] {key} {label}: {n} rays x {kw['n_samples']} samples, "
            f"width {W}, block {kw['block']}, chunks of {chunk} samples, "
            f"{composited / (n * kw['n_samples']):.4f} of the (ray, sample) "
            f"pairs composited; max_abs_err rgb {rgb_err:.3e} depth "
            f"{depth_err:.3e} ({share:.3e} of rgb values differ), two runs "
            f"bit-equal, kernel {ms:.4f} ms (median of 20; "
            f"device {dev_ms:.4f} ms by {how}), plain "
            f"{plain_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
            f"{ops_done / 1e9:.2f} GFLOP at the {unit} rate, "
            f"{moved / 1e6:.1f} MB{bounds}), three torch.matmul in "
            f"{str(dtype)[6:]} over all rows {matmul_ms:.4f} ms")
        rows.setdefault(key, {
            "name": key, "route": "cuda", "source": RENDER_SOURCE,
            "replaces": RENDER_REPLACES[key], "launches": None,
            "max_abs_err": max(rgb_err, depth_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "device_ms": dev_ms,
            **({"bound_f32_ms": t_f32, "bound_tf32_ms": t_tf32} if bounds else {}),
        })
        del got, again, want_rgb, want_depth
        torch.cuda.empty_cache()
    return list(rows.values())


def phase_render_small(fields, n: int = 300):
    """A few hundred sphere rays on the card and by the plain path on the
    CPU, same weights and flags (built on the card): every width, float32
    and bf16 operands, and int8."""
    o, d = sphere_scene(SEED + 13, n)[:2]
    before = _build.launch_counts.copy()
    worst, enc_q = {}, {}
    for width, f in fields.items():
        block, s_chunk = 64, 4 * width // 128  # chunks of 4 samples
        kw = dict(jitter=0.5, n_samples=32, near=2.0, far=6.0, block=block,
                  s_chunk=s_chunk, early_stop_eps=RENDER_EPS)
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            params = {k: v.float().to(dtype) for k, v in f.params.items()}
            flags = qf = None
            outs = collections.defaultdict(dict)  # kind -> device -> outputs
            for dev in ("cuda", "cpu"):
                p = {k: v.to(dev) for k, v in params.items()}
                A, c = f.A.to(dev), f.c.to(dev)
                oe, de = encode_rays(o.to(dev), d.to(dev), A, c)
                df = direction_features(p, d.to(dev), A, c)
                ws = [p[k] for k in ("w1", "w2", "w3")]
                if width != 128:
                    outs[name][dev] = rk.render_fused_packed(
                        oe, de, *ws, df, width=width, **kw)
                    continue
                if flags is None:  # on the card, then copied
                    ivol = field_integral_volume(
                        {k: v.float() for k, v in p.items()}, f.cfg,
                        resolution=32)
                    flags = chunk_flags(o, d, ivol, block=block, n_samples=32,
                                        s_chunk=s_chunk, near=2.0, far=6.0,
                                        extent=6.0)
                outs[name][dev] = rk.render_fused(oe, de, *ws, df,
                                                  flags=flags.to(dev), **kw)
                if dtype == torch.float32:
                    # the int8 encoding of the middle sample (t = 4.0625)
                    enc_q[dev] = torch.round(
                        torch.sin(oe + 4.0625 * de) * 127.0).cpu()
                    if qf is None:
                        qf = rk.quantize_field(
                            {k: v.cpu().numpy() for k, v in p.items()},
                            oe.cpu().numpy(), de.cpu().numpy(),
                            df.cpu().numpy())
                    outs["int8"][dev] = rk.render_fused_int8(
                        oe, de, qf, df, flags=flags.to(dev), **kw)
            for kind, by_dev in outs.items():
                card, host = by_dev["cuda"], by_dev["cpu"]
                rgb_err = float((card[0].cpu() - host[0]).abs().max())
                depth_err = float((card[1].cpu() - host[1]).abs().max())
                rgb_tol, depth_tol = SMALL_RENDER_TOL[kind]
                if not (rgb_err <= rgb_tol and depth_err <= depth_tol):
                    raise AssertionError(
                        f"render-small: w{width} {kind}: rgb {rgb_err}, "
                        f"depth {depth_err} against the CPU plain path")
                worst[f"w{width} {kind}"] = (rgb_err, depth_err)
    launched = _build.launch_counts - before
    want = {"render[f32]": 1, "render[bf16]": 1, "render[int8]": 1,
            "render[w64]": 1, "render[w32]": 1, "render[f32-w64]": 1,
            "render[f32-w32]": 1}
    if launched != want:
        raise AssertionError(f"render-small: launches {dict(launched)}")
    differ = float((enc_q["cuda"] != enc_q["cpu"]).float().mean())
    log(f"[render-small] {n} sphere rays, card against the CPU plain path "
        "(rgb, depth): " + "; ".join(
            f"{k} {a:.3e}, {b:.3e}" for k, (a, b) in worst.items())
        + f"; {differ:.3e} of the int8 encodings of one sample differ "
          "between the card's sine and the CPU's")


# ------------------------------------------------- row 8: fused sampling


def slice_ties(infer, requests, cfg):
    """Per image of the requests: the length of the run of equal
    probabilities at the candidate cut (rank TOP_K), 0 where the cut
    falls between two values."""
    runs = []
    for images in requests:
        probs = infer.serving(images, softmax=True)["probs"]
        flat = probs[..., :cfg.grid_size ** 2].reshape(probs.shape[0], -1)
        top = torch.topk(flat, TOP_K + 1, dim=1).values
        cut = top[:, TOP_K - 1:TOP_K]
        run = (flat == cut).sum(dim=1)
        runs += torch.where(top[:, TOP_K] == cut[:, 0], run, 0).tolist()
    return runs


def phase_ties(infer, requests, cfg):
    """How many images of the requests hold a tie run at the candidate
    cut, and what the defined tie order costs: the int64-key top-k of
    ``_cell_candidates`` against one ``torch.topk`` over the bf16
    probabilities (no defined order), on one request's probabilities."""
    runs = [r for r in slice_ties(infer, requests, cfg) if r]
    n = len(requests) * BATCH
    text = (f"runs of {min(runs)}-{max(runs)} equal values, median "
            f"{statistics.median(runs)}" if runs else "no run")
    log(f"[ties] {len(runs)} of {n} images of the [slice] requests have a "
        f"tie run at the {TOP_K}-candidate cut ({text}); the port takes its "
        "lowest raster indices")
    probs = infer.serving(requests[0], softmax=True)["probs"]
    Wc, g2 = probs.shape[2], cfg.grid_size ** 2
    flat = probs[..., :g2].reshape(probs.shape[0], -1)
    ordered = lambda: _cell_candidates(flat, Wc, cfg.grid_size, TOP_K)  # noqa: E731
    plain = lambda: torch.topk(flat, TOP_K, dim=1)  # noqa: E731
    times = [cuda_ms(f, reps=20, warmup=3) for f in (plain, ordered,
                                                     ordered, plain)]
    log(f"[ties] candidates at batch {BATCH}: _cell_candidates (int64 key, "
        f"defined order) {times[1]:.4f}, {times[2]:.4f} ms; torch.topk of "
        f"the bf16 values {times[0]:.4f}, {times[3]:.4f} ms (medians of 20)")


def grid_sample_descriptors(d_nchw, pts, grid_size):
    """The yardstick: ``F.grid_sample`` bicubic with border padding (taps
    clamped, a = -0.75, float32 weights) at pixel p = 2 (p + 0.5) /
    (grid_size n) - 1, then the same normalization."""
    _, _, Hc, Wc = d_nchw.shape
    gy = 2.0 * (pts[..., 0] + 0.5) / (grid_size * Hc) - 1.0
    gx = 2.0 * (pts[..., 1] + 0.5) / (grid_size * Wc) - 1.0
    out = F.grid_sample(d_nchw, torch.stack([gx, gy], -1)[:, None],
                        mode="bicubic", padding_mode="border",
                        align_corners=False)[:, :, 0].transpose(1, 2)
    return out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-12)


def desc_sample_work(desc, pts, grid_size):
    """(multiply-adds, bytes read once + written once) of one call: the
    distinct taps of each point times C; the map, points and float32
    output."""
    B, Hc, Wc, C = desc.shape
    _, _, fy = ds.axis_taps(pts[..., 0], Hc, grid_size)
    _, _, fx = ds.axis_taps(pts[..., 1], Wc, grid_size)
    taps = sum(f.long() for f in fy) * sum(f.long() for f in fx)
    out_bytes = B * pts.shape[1] * C * 4
    return int(taps.sum()) * C, nbytes(desc, pts) + out_bytes


def desc_sample_sets(infer, images, cfg):
    """The operand sets of ``[desc-sample]``: (label, map, points). The
    request's bf16 map, the micro-benchmark's and the borders take the
    ring instance, the request's map in float32 and a 480 x 960 frame's
    bf16 map the gather."""
    out = infer.serving(images, softmax=True)
    pts, _, _ = detect_from_probs_padded(
        out["probs"], cfg.grid_size, min_prob=cfg.det_thresh, size=cfg.nms,
        top_k=TOP_K, num_candidates=TOP_K, compact=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    B, Hc, Wc, C = out["desc_raw"].shape
    micro = torch.randn((B, Hc, Wc, C), generator=gen, device="cuda").bfloat16()
    micro_pts = torch.stack([
        torch.rand((B, DESC_MICRO_K), generator=gen, device="cuda")
        * (Hc * cfg.grid_size - 1),
        torch.rand((B, DESC_MICRO_K), generator=gen, device="cuda")
        * (Wc * cfg.grid_size - 1)], -1)
    # corners, the four borders and up to 12 pixels beyond them, K 300
    h, w = Hc * cfg.grid_size - 1, Wc * cfg.grid_size - 1
    edge = torch.linspace(-12.0, 12.0, 25, device="cuda")
    along = torch.linspace(0.0, 1.0, 25, device="cuda")
    border = torch.cat([
        torch.tensor([[0.0, 0.0], [0.0, w], [h, 0.0], [h, w]], device="cuda"),
        torch.stack([edge, along * w], -1), torch.stack([h + edge, along * w], -1),
        torch.stack([along * h, edge], -1), torch.stack([along * h, w + edge], -1),
        torch.stack([edge, edge], -1), torch.stack([h + edge, w + edge], -1),
        torch.rand((300 - 154, 2), generator=gen, device="cuda")
        * torch.tensor([h + 24.0, w + 24.0], device="cuda") - 12.0])
    # a 480 x 960 frame's map: rows too wide for the ring's five slots
    wide = torch.randn((8, Hc, 2 * Wc, C), generator=gen,
                       device="cuda").bfloat16()
    wide_pts = pts[:8] * torch.tensor([1.0, 2.0], device="cuda")
    return [("slice request", out["desc_raw"], pts),
            ("micro_desc_sample shapes", micro, micro_pts),
            ("borders", out["desc_raw"][:2].contiguous(),
             border[None].expand(2, -1, -1).contiguous()),
            ("float32 map", out["desc_raw"].float(), pts),
            ("480 x 960 map", wide, wide_pts.contiguous())]


def band_shares(d, p, grid_size):
    """The ring's largest band's share of an image's points, as the mean
    over images: (with equal row bands, with the kernel's bands), at the
    default band count."""
    B, Hc = d.shape[:2]
    bands = ds.default_bands(
        B, Hc, torch.cuda.get_device_properties(d.device).multi_processor_count)
    base = ds.base_rows(p[..., 0], Hc, grid_size).cpu()
    shares = []
    for plan in (lambda counts: ds.band_rows([0] * Hc, bands),
                 lambda counts: ds.band_rows(counts, bands)):
        top = 0.0
        for b in base:
            counts = torch.bincount(b, minlength=Hc).tolist()
            top += max(sum(counts[r0:r1]) for r0, r1, _, _ in plan(counts))
        shares.append(top / (B * p.shape[1]))
    return bands, shares


def phase_desc_sample(infer, images, cfg, peaks):
    """Row 8: drive the kernel once on each operand set with the launch
    counters at 0, then hold it against its plain version (within
    DESC_PLAIN_TOL, two runs bit-equal), the request's own one-hot output
    (within DESC_ONEHOT_TOL) and time it beside the plain version, the
    one-hot product, ``grid_sample`` + normalize and the bound; one kernel
    row per instance, from its first operand set, with the device time
    (``torch.profiler``)."""
    _, mem_rate, f32_rate, _ = peaks
    sets = desc_sample_sets(infer, images, cfg)
    keys = [ds.instance(d.dtype, *d.shape[1:], p.shape[1])[0]
            for _, d, p in sets]
    _, _, _, onehot = infer(images)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    outs = [ds.sample_descriptors_fused(d, p, cfg.grid_size)
            for _, d, p in sets]
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    if counts != dict(collections.Counter(keys)):
        raise AssertionError(f"[desc-sample] launches {counts}, expected "
                             f"those of the instances the shapes take, {keys}")
    log(f"[desc-sample] launches: {json.dumps(counts)}")
    rows = {}
    for (label, d, p), got, key in zip(sets, outs, keys):
        fn = lambda: ds.sample_descriptors_fused(d, p, cfg.grid_size)  # noqa: E731
        want = ds.sample_descriptors_fused_plain(d, p, cfg.grid_size)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= DESC_PLAIN_TOL
                and torch.equal(got, fn())):
            raise AssertionError(f"[desc-sample] {label}: max |kernel - "
                                 f"plain| {err}, or not finite or not "
                                 "bit-equal in two runs")
        norm_err = float((got.norm(dim=-1) - 1).abs().max())
        d_nchw = d.float().permute(0, 3, 1, 2).contiguous()
        lib_err = float((grid_sample_descriptors(d_nchw, p, cfg.grid_size)
                         - want).abs().max())
        text = (f"[desc-sample] {label}: map {tuple(d.shape)} {d.dtype}, "
                f"points {tuple(p.shape)}: max |kernel - plain| {err:.3e}, "
                f"two runs equal, max |norm - 1| {norm_err:.3e}, grid_sample "
                f"off by {lib_err:.3e}")
        if key == ds.RING[0]:
            bands, (equal, kernel) = band_shares(d, p, cfg.grid_size)
            text += (f", {bands} bands an image: the largest holds "
                     f"{equal:.3f} of its points with equal rows, "
                     f"{kernel:.3f} with the kernel's split")
        if label == "slice request":
            onehot_err = float((got - onehot).abs().max())
            if onehot_err > DESC_ONEHOT_TOL:
                raise AssertionError(f"[desc-sample] against the request's "
                                     f"one-hot output: {onehot_err}")
            text += f", max |kernel - one-hot output| {onehot_err:.3e}"
        log(text)
        if label == "borders":
            continue
        before = _build.launch_counts[key]
        ms = cuda_ms(fn, reps=20, warmup=3)
        if _build.launch_counts[key] != before + 23:
            raise AssertionError("[desc-sample] the counter did not rise by "
                                 "1 per call")
        dev_ms, how = device_ms(fn, "desc_sample")
        plain_ms = cuda_ms(lambda: ds.sample_descriptors_fused_plain(
            d, p, cfg.grid_size), reps=3)
        onehot_ms = cuda_ms(lambda: sample_descriptors_onehot(
            d, p, cfg.grid_size), reps=5)
        lib_ms = cuda_ms(lambda: grid_sample_descriptors(
            d_nchw, p, cfg.grid_size), reps=20, warmup=3)
        macs, moved = desc_sample_work(d, p, cfg.grid_size)
        t_ops, t_bytes = 2 * macs / f32_rate * 1e3, moved / mem_rate * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"[kernel] {key} ({label}): kernel {ms:.4f} ms (median of "
            f"20; device {dev_ms:.4f} ms, {how}), plain {plain_ms:.4f} ms, "
            f"one-hot product {onehot_ms:.4f} ms, grid_sample + normalize "
            f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
            f"{2 * macs / 1e9:.3f} GFLOP, {moved / 1e6:.1f} MB)")
        if key not in rows:  # the instance's first set: for the ring, the
            # slice request's operands
            rows[key] = {
                "name": key, "route": "cuda", "source": DESC_SOURCE,
                "replaces": DESC_REPLACES, "launches": counts[key],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                "device_ms": dev_ms}
        del want, d_nchw
        torch.cuda.empty_cache()
    return list(rows.values())


# ------------------------------------------------------ HPatches export


def hpatches_model(kind: str):
    """The config's model, seeded, then restored from the demo MagicPoint
    checkpoint by the port's own msgpack reader (the descriptor head keeps
    its seed-0 weights: the checkpoint has none); (config, model)."""
    config = copy.deepcopy(HP_CONFIGS[kind])
    config.update(HP_CUTS)
    model = restored_model(config)
    seeded = init_superpoint(SEED, model.config, device=DEV).state_dict()
    kept = sorted(k for k, v in model.state_dict().items()
                  if torch.equal(v, seeded[k]) and k.endswith("weight"))
    if any(not k.startswith("descriptor.") for k in kept):
        raise AssertionError(f"[hpatches] not restored: {kept}")
    return config, model


def hpatches_pairs(n: int, size, seed: int):
    """n synthetic pairs on the host: blobs with a bright rectangle, and
    their warps by homographies of ``sample_homographies``."""
    h, w = size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    image = synthetic_images(n, gen, size) * 0.6
    image[:, h // 4:h // 2, w // 4:w // 2] += 0.4
    homs = sample_homographies(torch.Generator().manual_seed(seed), n, size,
                               HomographyConfig.from_dict(HP_HOMOGRAPHY))
    warped = warp_image(image, homs.cuda())
    image, warped, homs = (t.cpu().numpy() for t in (image, warped, homs))
    return [{"image": image[i:i + 1], "warped_image": warped[i:i + 1],
             "homography": homs[i:i + 1], "name": [f"pair{i:02d}"]}
            for i in range(n)]


def check_bundles(out_dir: Path, n: int, size, with_descriptors, det_thresh):
    keys = {"image", "warped_image", "prob", "warped_prob", "homography"}
    if with_descriptors:
        keys |= {"desc", "warped_desc"}
    files = sorted(out_dir.glob("*.npz"))
    if len(files) != n:
        raise AssertionError(f"[hpatches] {len(files)} bundles for {n} pairs")
    counts, worst_norm = [], 0.0
    for f in files:
        b = np.load(f)
        if set(b.files) != keys:
            raise AssertionError(f"{f.name}: keys {sorted(b.files)}")
        for k in keys:
            shape = {"homography": (3, 3), "desc": size + (256,),
                     "warped_desc": size + (256,)}.get(k, size)
            if b[k].shape != shape or b[k].dtype != np.float32:
                raise AssertionError(f"{f.name}: {k} {b[k].shape} "
                                     f"{b[k].dtype}")
        for k in ("prob", "warped_prob"):
            pts = export._nms_threshold_points(b[k], det_thresh)
            if len(pts) == 0:
                raise AssertionError(f"{f.name}: no {k} at or above "
                                     f"{det_thresh}")
            counts.append(len(pts))
        if with_descriptors:
            for k in ("desc", "warped_desc"):
                norm = np.linalg.norm(b[k].astype(np.float64), axis=-1)
                worst_norm = max(worst_norm, float(np.abs(norm - 1).max()))
    if worst_norm > 1e-5:
        raise AssertionError(f"[hpatches] descriptor norms off by "
                             f"{worst_norm}")
    return counts, worst_norm


def phase_hpatches(root: Path):
    """``export_hpatches`` of both kinds at their configs' full widths and
    sizes, on synthetic pairs; bundles checked, pairs/s and the device
    time of one pair's inference printed."""
    models = {}
    for kind, with_desc in (("repeatability", False), ("descriptors", True)):
        config, model = hpatches_model(kind)
        size = tuple(config["data"]["preprocessing"]["resize"])
        n = HP_PAIRS[kind]
        batches = hpatches_pairs(n, size, SEED + 30)
        export.EXPER_PATH = root
        x = torch.from_numpy(batches[0]["image"]).cuda()
        superpoint_inference(model, x)  # warm-up: cuDNN plans
        infer_ms = cuda_ms(lambda: superpoint_inference(model, x), reps=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_dir = export.export_hpatches(config, model, batches,
                                         with_descriptors=with_desc)
        seconds = time.perf_counter() - t0
        counts, worst_norm = check_bundles(out_dir, n, size, with_desc,
                                           model.config.det_thresh)
        log(f"[hpatches] {kind} ({config['data']['experiment_name']}, "
            f"{size[0]}x{size[1]}, demo checkpoint at iteration 5000): {n} "
            f"pairs in {seconds:.3f} s, {n / seconds:.3f} pairs/s; "
            f"inference {infer_ms:.4f} ms per image (median of 5); "
            f"{min(counts)}-{max(counts)} keypoints per image at or above "
            f"{model.config.det_thresh}"
            + (f"; max |norm - 1| of desc {worst_norm:.3e}" if with_desc
               else ""))
        models[kind] = (config, model)
    return models


def phase_hpatches_small(config, model, root: Path):
    """2 pairs of 64 x 80 through ``export_hpatches`` with descriptors on
    the card and by the plain path on the CPU (same weights): prob and
    desc within HP_SMALL_TOL, keypoint sets equal away from the threshold
    and from NMS near-ties."""
    batches = hpatches_pairs(2, (64, 80), SEED + 31)
    cpu_model = copy.deepcopy(model).cpu()
    dirs = {}
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        export.EXPER_PATH = root / dev
        dirs[dev] = export.export_hpatches(config, m, batches,
                                           with_descriptors=True, device=dev)
    det = model.config.det_thresh
    worst, apart = 0.0, 0
    for f in sorted(dirs["cpu"].glob("*.npz")):
        got, want = np.load(dirs["cuda"] / f.name), np.load(f)
        for k in ("prob", "warped_prob", "desc", "warped_desc"):
            worst = max(worst, float(np.abs(got[k] - want[k]).max()))
        for k, img in (("prob", "image"), ("warped_prob", "warped_image")):
            dense = superpoint_inference(cpu_model, torch.from_numpy(
                want[img][None, ..., None]))["prob_heatmap"][0].numpy()
            a = {tuple(p) for p in export._nms_threshold_points(got[k], det)}
            b = {tuple(p) for p in export._nms_threshold_points(want[k], det)}
            for y, x in a ^ b:
                win = dense[max(y - 3, 0):y + 4, max(x - 3, 0):x + 4]
                near_tie = np.sort(np.abs(win - dense[y, x]).ravel())[1]
                if abs(dense[y, x] - det) > HP_SMALL_TOL \
                        and near_tie > HP_SMALL_TOL:
                    raise AssertionError(f"[hpatches-small] {f.name} {k}: "
                                         f"keypoint ({y}, {x}) on one side")
            apart += len(a ^ b)
    if worst > HP_SMALL_TOL:
        raise AssertionError(f"[hpatches-small] card against CPU: {worst}")
    log(f"[hpatches-small] 2 pairs of 64x80, card against the CPU plain "
        f"path: prob and desc within {worst:.3e}, {apart} keypoints on one "
        "side only (at the threshold or an NMS near-tie)")


# [cli]: the port's task CLI as a user runs it, on 4 synthetic HPatches-
# layout sequences (2 "i_", 2 "v_", 1.ppm-6.ppm and H_1_2-H_1_6 each, from
# 480 x 640 sources) and on the NeRF pair phases' box rooms
CLI_SEQUENCES = {"i": 2, "v": 2}
CLI_SOURCE = (480, 640)
CLI_PRETRAINED = "pretrained/demo_mp_5000.ckpt"
# cut of superpoint_descriptors.yaml for the bundles and the on-the-fly
# run: 120 x 160 in place of 480 x 640, whose dense float32 descriptors
# make a pair's bundle 629 MB for np.savez_compressed on one host core
CLI_DESC_CUTS = {"pretrained": CLI_PRETRAINED,
                 "data.preprocessing.resize": [120, 160]}
CLI_NERF_EXPER = "CLI_NeRF"
CLI_PROFILE = {"steps": 8, "start": 2, "num_steps": 5}
NMS_SHAPE, NMS_POINTS = (240, 320), 3000


def hpatches_sequences(root: Path) -> dict:
    """Write CLI_SEQUENCES under root/HPatches as 8-bit PPM (gray in all
    three channels): "i_" sequences change brightness and contrast under
    the identity, "v_" ones warp by seeded homographies of HP_HOMOGRAPHY.
    Returns {alteration: pairs}."""
    h, w = CLI_SOURCE
    n_seq = sum(CLI_SEQUENCES.values())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    base = synthetic_images(n_seq, gen, CLI_SOURCE) * 0.6
    base[:, h // 4:h // 2, w // 4:w // 2] += 0.4
    rng = np.random.default_rng(SEED + 50)
    k, pairs = 0, {}
    for kind, count in CLI_SEQUENCES.items():
        for j in range(count):
            image = base[k:k + 1].expand(5, -1, -1, -1).contiguous()
            if kind == "v":
                homs = sample_homographies(
                    torch.Generator().manual_seed(SEED + 50 + k), 5,
                    CLI_SOURCE, HomographyConfig.from_dict(HP_HOMOGRAPHY))
                others = warp_image(image, homs.cuda())
            else:
                homs = torch.eye(3).expand(5, 3, 3)
                gain = torch.from_numpy(rng.uniform(0.6, 1.4, 5)).float()
                bias = torch.from_numpy(rng.uniform(-0.15, 0.15, 5)).float()
                others = (image * gain.cuda()[:, None, None, None]
                          + bias.cuda()[:, None, None, None]).clamp(0, 1)
            folder = root / "HPatches" / f"{kind}_synthetic{j}"
            folder.mkdir(parents=True)
            frames = torch.cat([image[:1], others])
            u8 = (frames[..., 0] * 255).round().to(torch.uint8).cpu().numpy()
            for i in range(6):
                pnm.write(folder / f"{i + 1}.ppm",
                          np.repeat(u8[i][..., None], 3, axis=2))
            for i in range(2, 7):
                np.savetxt(folder / f"H_1_{i}", homs[i - 2].double().numpy())
            pairs[kind] = pairs.get(kind, 0) + 5
            k += 1
    return pairs


def bundle_repeatabilities(exper: str) -> list:
    """Per-pair repeatability (None without points) of the bundles under
    EXPER_PATH/repeatability/<exper>, in file order."""
    reps = []
    for path in sorted(Path(settings.EXPER_PATH, "repeatability", exper)
                       .glob("*.npz")):
        b = np.load(path)
        reps.append(eval_detector.repeatability_pair(
            b["prob"], b["warped_prob"], b["homography"])[0])
    return reps


def phase_cli_hpatches(pairs: dict) -> None:
    """(c)-(e): the repeatability export through ``python3 -m
    spnerf_tpu_torch.cli`` in a child process, the descriptor export
    through ``cli.main`` in this one, both scored by ``eval.detector`` /
    ``eval.descriptor``, then ``eval.on_the_fly.main`` in both modes over
    the same sequences."""
    here = Path(__file__).resolve().parent
    rep_cfg = CONFIGS / "magicpoint_repeatability.yaml"
    desc_cfg = CONFIGS / "superpoint_descriptors.yaml"
    env = dict(os.environ, SPNERF_DATA_PATH=str(settings.DATA_PATH),
               SPNERF_EXPER_PATH=str(settings.EXPER_PATH),
               SPNERF_CKPT_PATH=str(settings.CKPT_PATH))
    cmd = [sys.executable, "-m", "spnerf_tpu_torch.cli", "--config-path",
           str(rep_cfg.relative_to(here)), "--task",
           "export_HPatches_Repeatability", "--set",
           f"pretrained={CLI_PRETRAINED}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                          text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[cli] {' '.join(cmd)} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    rep_exper = HP_CONFIGS["repeatability"]["data"]["experiment_name"]
    reps = bundle_repeatabilities(rep_exper)
    n_rep = len(reps)
    if n_rep != pairs["i"]:
        raise AssertionError(f"[cli] {n_rep} repeatability bundles for "
                             f"{pairs['i']} pairs")
    t0 = time.perf_counter()
    rep_mean = eval_detector.compute_repeatability(rep_exper)
    rep_s = time.perf_counter() - t0
    valid = [r for r in reps if r is not None]
    lo, hi = on_the_fly.bootstrap_ci(valid)
    if not (0.0 <= rep_mean <= 1.0 and valid):
        raise AssertionError(f"[cli] repeatability {rep_mean} over "
                             f"{len(valid)} pairs")
    log(f"[cli] python3 -m spnerf_tpu_torch.cli --task "
        f"export_HPatches_Repeatability ({rep_cfg.name}, --set pretrained="
        f"{CLI_PRETRAINED}; {pairs['i']} pairs of {len(CLI_SEQUENCES)} kinds "
        f"of synthetic sequences at 240x320) in a child process: "
        f"{child_s:.3f} s with the interpreter's start = "
        f"{n_rep / child_s:.3f} pairs/s; eval.detector.compute_repeatability "
        f"{rep_mean:.4f} (95% CI [{lo:.4f}, {hi:.4f}]) in {rep_s:.3f} s")

    saved_exper = export.EXPER_PATH
    export.EXPER_PATH = settings.EXPER_PATH
    try:
        t0 = time.perf_counter()
        out_dir = cli.main(["--config-path", str(desc_cfg), "--task",
                            "export_HPatches_Descriptors"]
                           + set_args(CLI_DESC_CUTS))
        torch.cuda.synchronize()
        desc_s = time.perf_counter() - t0
    finally:
        export.EXPER_PATH = saved_exper
    size = tuple(CLI_DESC_CUTS["data.preprocessing.resize"])
    det = HP_CONFIGS["descriptors"]["model"]["detector_head"]["det_thresh"]
    counts, worst_norm = check_bundles(out_dir, pairs["v"], size, True, det)
    desc_exper = HP_CONFIGS["descriptors"]["data"]["experiment_name"]
    t0 = time.perf_counter()
    correct, mscore = eval_descriptor.homography_estimation(desc_exper)
    score_s = time.perf_counter() - t0
    log(f"[cli] cli.main --task export_HPatches_Descriptors ({desc_cfg.name}, "
        f"cuts {json.dumps(CLI_DESC_CUTS)}; descriptor head from seed 0): "
        f"{pairs['v']} pairs in {desc_s:.3f} s = {pairs['v'] / desc_s:.3f} "
        f"pairs/s, {min(counts)}-{max(counts)} keypoints per image, max "
        f"|norm - 1| {worst_norm:.3e}; eval.descriptor.homography_estimation "
        f"correctness {correct:.4f}, matching score {mscore:.4f} in "
        f"{score_s:.3f} s")

    jsonl = Path(settings.EXPER_PATH) / "on_the_fly.jsonl"
    runs = (("repeatability", rep_cfg, {"pretrained": CLI_PRETRAINED}),
            ("descriptors", desc_cfg, CLI_DESC_CUTS))
    for mode, cfg_path, cuts in runs:
        t0 = time.perf_counter()
        res = on_the_fly.main(["--config-path", str(cfg_path), "--mode", mode,
                               "--json-out", str(jsonl)] + set_args(cuts))
        secs = time.perf_counter() - t0
        n = pairs["i" if mode == "repeatability" else "v"]
        if res["pairs"] != n:
            raise AssertionError(f"[cli] on-the-fly {mode}: {res}")
        metrics = {k: v for k, v in res.items() if k != "pairs"}
        if not all(np.isfinite(v) for k, v in metrics.items()
                   if not k.endswith("ci95")):
            raise AssertionError(f"[cli] on-the-fly {mode}: {res}")
        log(f"[cli] eval.on_the_fly --mode {mode} ({cfg_path.name}, cuts "
            f"{json.dumps(cuts)}): {n} pairs in {secs:.3f} s = "
            f"{n / secs:.3f} pairs/s; {json.dumps(metrics)}"
            + (f"; bundles {rep_mean:.4f}" if mode == "repeatability"
               else f"; bundles {correct:.4f}, {mscore:.4f}"))
    if len(jsonl.read_text().splitlines()) != 2:
        raise AssertionError("[cli] --json-out did not append two records")


def phase_cli_nerf(root: Path) -> dict:
    """(f)-(g): ``export_NeRF_labels`` through ``cli.main`` for both box
    rooms and splits (the labels equal those of [nerf-export], the same
    model, config and seed), then ``--task train --train-nerf --nerf-loss
    --validate-training`` on superpoint_NeRF_train.yaml with NERF_CUTS
    over those labels, the launch counters at 0 before: rows 10-11 launch
    once per step, the forward once more per validation batch; then a
    short run with a ``profile:`` window that must leave a Chrome trace
    holding the card's kernels. Returns the training run's launches."""
    export_cfg = CONFIGS / "magicpoint_NeRF_export.yaml"
    t0 = time.perf_counter()
    frames = 0
    for scene in NERF_SCENES:
        for split in ("training", "validation"):
            out_dir = cli.main(
                ["--config-path", str(export_cfg), "--task",
                 "export_NeRF_labels", "--split", split]
                + set_args({"pretrained": CLI_PRETRAINED,
                            "data.data_dir": scene,
                            "data.experiment_name":
                                f"{CLI_NERF_EXPER}/{scene}"}))
            ref = Path(settings.EXPER_PATH, "outputs", "MP_NeRF_v1", scene,
                       split)
            files = sorted(p.name for p in out_dir.glob("*.npy"))
            if files != sorted(p.name for p in ref.glob("*.npy")) \
                    or not files:
                raise AssertionError(f"[cli] {scene} {split}: {files}")
            for name in files:
                if not np.array_equal(np.load(out_dir / name),
                                      np.load(ref / name)):
                    raise AssertionError(f"[cli] {scene} {split} {name}: "
                                         "labels differ from [nerf-export]")
            frames += len(files)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    log(f"[cli] cli.main --task export_NeRF_labels ({export_cfg.name}, "
        f"--set pretrained, data.data_dir, data.experiment_name), 2 scenes x "
        f"2 splits: {frames} frames in {export_s:.3f} s = "
        f"{frames / export_s:.2f} frames/s (each call builds and restores "
        "its model); every label file equal to [nerf-export]'s")

    train_cfg = CONFIGS / "superpoint_NeRF_train.yaml"
    cuts = dict(NERF_CUTS, ckpt_name="cli_nerf")
    cuts["data.all_label_dirs"] = [f"outputs/{CLI_NERF_EXPER}/{s}"
                                   for s in NERF_SCENES]
    args = ["--config-path", str(train_cfg), "--task", "train",
            "--train-nerf", "--nerf-loss", "--validate-training"]
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    state = cli.main(args + set_args(cuts))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    steps, n_val = cuts["train.num_iters"], cuts["train.val_batches"]
    expect = {"desc_loss[fwd]": steps + n_val, "desc_loss[dA]": steps,
              "desc_loss[dB]": steps}
    got = {k: v for k, v in counts.items() if k.startswith("desc_loss")}
    if state.iteration != steps or got != expect:
        raise AssertionError(f"[cli] train: {state.iteration} steps, "
                             f"launches {got}, expected {expect}")
    metrics = read_metrics("cli_nerf")
    for tag, rows in metrics.items():
        if not all(np.isfinite(v) for _, v in rows):
            raise AssertionError(f"[cli] train: {tag} is not finite: {rows}")
    losses = metrics["iter_loss/loss"]
    if not losses[-1][1] < losses[0][1]:
        raise AssertionError(f"[cli] train: the loss did not fall: {losses}")
    rates = [v for _, v in metrics["perf/steps_per_sec"]]
    log(f"[cli] cli.main --task train --train-nerf --nerf-loss "
        f"--validate-training ({train_cfg.name}, cuts {json.dumps(cuts)}): "
        f"{steps} steps + validation of {n_val} batches + checkpoint in "
        f"{secs:.4f} s (model build and loaders included); perf/"
        f"steps_per_sec (StepTimer, windows of 5): "
        f"{', '.join(f'{r:.2f}' for r in rates)}; loss "
        f"{', '.join(f'{s_}: {v:.4f}' for s_, v in losses)}; launches "
        f"{json.dumps(got, sort_keys=True)}")
    del state

    trace_dir = root / "trace"
    prof = {"enable": True, "logdir": str(trace_dir),
            "start": CLI_PROFILE["start"],
            "num_steps": CLI_PROFILE["num_steps"]}
    pcuts = dict(cuts, ckpt_name="cli_profile", profile=prof)
    pcuts.update({"train.num_iters": CLI_PROFILE["steps"],
                  "save_or_validation_interval": CLI_PROFILE["steps"]})
    t0 = time.perf_counter()
    cli.main(args[:-1] + set_args(pcuts))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    traces = sorted(trace_dir.glob("*.json"))
    if len(traces) != 1:
        raise AssertionError(f"[cli] profile: {len(traces)} trace files")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    hinge = [e for e in kernels if "hinge" in e.get("name", "")]
    if not hinge:
        raise AssertionError(f"[cli] profile: no descriptor-loss kernel in "
                             f"the trace ({len(kernels)} kernel events)")
    log(f"[cli] profile: {{enable, start {prof['start']}, num_steps "
        f"{prof['num_steps']}}} in a run of {CLI_PROFILE['steps']} steps "
        f"({secs:.3f} s): {traces[0].name}, "
        f"{traces[0].stat().st_size / 1e6:.1f} MB, {len(events)} events, "
        f"{len(kernels)} kernel launches on the card, {len(hinge)} of them "
        f"rows 10-11 ({sorted({e['name'] for e in hinge})})")
    return counts


def phase_native_nms() -> None:
    """(h): ``ops.native_nms.exact_nms`` (the port's own source, built by
    g++ here) on a seeded sparse heatmap against ``ops.nms.box_nms_greedy``
    (torch, CPU), with and without keep_top_k."""
    rng = np.random.default_rng(SEED + 60)
    prob = np.zeros(NMS_SHAPE, np.float32)
    ys = rng.integers(0, NMS_SHAPE[0], NMS_POINTS)
    xs = rng.integers(0, NMS_SHAPE[1], NMS_POINTS)
    prob[ys, xs] = rng.uniform(0.02, 1.0, NMS_POINTS).astype(np.float32)
    t0 = time.perf_counter()
    native_nms.exact_nms(prob[:8, :8])  # builds the library
    build_s = time.perf_counter() - t0
    for top_k in (0, 300):
        t0 = time.perf_counter()
        got = native_nms.exact_nms(prob, 4, 0.1, 0.015, top_k)
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = box_nms_greedy(torch.from_numpy(prob), 4, 0.1, 0.015,
                              top_k).numpy()
        greedy_ms = (time.perf_counter() - t0) * 1e3
        err = float(np.abs(got - want).max())
        if err > 1e-7:
            raise AssertionError(f"[cli] native NMS against the greedy NMS: "
                                 f"{err}")
        log(f"[cli] native NMS {NMS_SHAPE[0]}x{NMS_SHAPE[1]}, {NMS_POINTS} "
            f"seeded candidates, keep_top_k {top_k}: {int((got > 0).sum())} "
            f"kept, equal to ops.nms.box_nms_greedy (max |diff| {err:.1e}); "
            f"{native_ms:.3f} ms against {greedy_ms:.1f} ms (host clock)"
            + (f"; g++ build and load {build_s:.3f} s" if not top_k else ""))


def phase_cli(root: Path) -> dict:
    """The [cli] phase: (a) every config of the port read by its own
    reader; (b)-(e) HPatches through the CLI and the evaluation; (f)-(g)
    NeRF labels, training and a profile window through the CLI; (h) the
    native NMS. Returns the CLI training run's launches."""
    t0 = time.perf_counter()
    names = sorted(p.name for p in CONFIGS.glob("*.yaml"))
    configs = {name: load_config(CONFIGS / name) for name in names}
    if len(configs) != 11 or not all(isinstance(c, dict)
                                     for c in configs.values()):
        raise AssertionError(f"[cli] configs: {names}")
    log(f"[cli] {len(configs)} configs read by utils.config.load_config "
        f"(yaml importable: {importlib.util.find_spec('yaml') is not None}) "
        f"in {(time.perf_counter() - t0) * 1e3:.2f} ms: {', '.join(names)}")
    pairs = hpatches_sequences(Path(settings.DATA_PATH))
    phase_cli_hpatches(pairs)
    counts = phase_cli_nerf(root)
    phase_native_nms()
    return counts


# [pose]: the relative-pose evaluation (``eval/pose.py``; no kernel) over
# posed pairs of one box room, from the demo MagicPoint (descriptor head
# from seed 0); [quant]: the int8 PTQ graph (``ops/quantization.py``; no
# kernel) at full width
POSE_SEED = SEED + 60
POSE_SCENE = "PoseRoom"
POSE_FRAMES = 14  # 13 pairs at gaps of 2-5 frames, 3 of them again turned
POSE_ROTATIONS = ((1, 1), (2, 0), (0, 3))
POSE_CONFIG = CONFIGS / "pose_estimation_indoor.yaml"
POSE_CUTS = {"data.resize": [W, H], "model.detector_head.top_k": TOP_K,
             "pretrained": "pretrained/demo_mp_5000.ckpt",
             "data.images_path": POSE_SCENE,
             "data.gt_pairs": f"{POSE_SCENE}/pairs.txt"}
# the estimator alone on matches from the scene's exact depth: as they are
# (above POSE_MAX_DEG a failure), and with seeded noise and outliers. On
# these short baselines the noisy matches leave the translation up to 61
# deg off, as cv2.findEssentialMat + cv2.recoverPose leave it on the same
# matches: there each pair's best model must hold POSE_NOISY_SUPPORT of the
# inliers that the true E holds (0.902-0.981 on the CPU), and each pair's
# (translation, rotation) error must repeat POSE_NOISY_DEG, the CPU run's
# (numpy; cv2 5.0 gives the same inlier masks), within POSE_NOISY_TOL deg
POSE_POINTS = 1000
POSE_NOISY = {"noise_px": 0.5, "outliers": 0.3}
POSE_MAX_DEG = 2.0
POSE_NOISY_SUPPORT = 0.85
POSE_NOISY_DEG = {
    "0-5": (1.4303, 0.6654), "1-5": (2.2571, 0.2761), "2-6": (4.9898, 0.6037),
    "3-8": (1.5959, 0.6091), "4-8": (3.6355, 0.3991), "5-10": (4.5032, 0.7121),
    "6-11": (36.0186, 3.7066), "7-9": (9.4844, 0.7183),
    "8-10": (43.1659, 1.6578), "9-12": (39.4924, 2.5162),
    "10-13": (45.9993, 2.5822), "11-13": (37.2617, 1.5257),
    "12-13": (60.8240, 1.0413)}
POSE_NOISY_TOL = 1e-3
POSE_SMALL, POSE_SMALL_TOL = (120, 160), 1e-5
QUANT_BATCH, QUANT_REPS, QUANT_BOUND = 8, 5, 0.1
QUANT_SMALL = (64, 80)


def write_pose_pairs(scene: dict, root: Path, rotations=POSE_ROTATIONS):
    """The frames of ``scene`` as 8-bit gray PNGs in ``root`` and a
    SuperGlue-format pair list ``root/pairs.txt`` (names relative to
    ``root``): each frame with the one 2-5 frames on (gaps drawn with seed
    7, as ``demo/render_gt_test_views.write_gt_pose_pairs`` draws them),
    then the first pairs again with the quarter-turns ``rotations`` (rot0,
    rot1). Returns the pairs as (i, j, rot0, rot1)."""
    root.mkdir(parents=True, exist_ok=True)
    poses = scene["poses"].astype(np.float64)
    n = len(poses)
    for f in range(n):
        gray = np.clip(scene["rgb"][f].mean(-1) * 255.0, 0, 255)
        write_gray(root / f"{f}.png", gray.astype(np.uint8))
    K = camera_intrinsics(scene["rgb"].shape[1:3], NERF_FOV)
    k_flat = " ".join(f"{v:.6f}" for v in K.ravel())
    rng = np.random.default_rng(7)
    pairs = [(i, min(i + int(rng.integers(2, 6)), n - 1), 0, 0)
             for i in range(n - 1)]
    pairs += [(i, j, r0, r1)
              for (i, j, _, _), (r0, r1) in zip(pairs, rotations)]
    lines = []
    for i, j, r0, r1 in pairs:
        T = np.linalg.inv(poses[j]) @ poses[i]
        t_flat = " ".join(f"{v:.8f}" for v in T.ravel())
        lines.append(f"{i}.png {j}.png {r0} {r1} {k_flat} {k_flat} {t_flat}")
    (root / "pairs.txt").write_text("\n".join(lines) + "\n")
    return pairs


def exact_matches(scene: dict, i: int, j: int, seed: int, noise_px=0.0,
                  outliers=0.0):
    """(x, y) pixel matches of frame ``i`` in frame ``j`` from the scene's
    exact depth, away from depth edges, with seeded Gaussian noise of
    ``noise_px`` and a share ``outliers`` moved to random pixels."""
    h, w = scene["rgb"].shape[1:3]
    src, dst = reprojection_truth(scene, i, j, POSE_POINTS, seed,
                                  shape=(h, w))
    rng = np.random.default_rng(seed)
    k0 = src[:, ::-1].astype(np.float64) + rng.normal(0, noise_px, src.shape)
    k1 = dst[:, ::-1] + rng.normal(0, noise_px, dst.shape)
    bad = rng.random(len(k1)) < outliers
    k1[bad] = rng.uniform([0, 0], [w - 1, h - 1], (int(bad.sum()), 2))
    return k0, k1


def pose_config(**cuts) -> dict:
    """pose_estimation_indoor.yaml with POSE_CUTS and ``cuts``."""
    return apply_overrides(load_config(POSE_CONFIG),
                           set_args(dict(POSE_CUTS, **cuts))[1::2])


def phase_pose(root: Path, card: str) -> None:
    """[pose]: render and write the pairs; run ``python3 -m
    spnerf_tpu_torch.eval.pose`` on them in a child process (the card);
    repeat the run in this process; split one pair; the estimator alone
    on exact matches; the card against the CPU at 120 x 160."""
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    scene = box_room(POSE_SEED, frames={"training": POSE_FRAMES,
                                        "validation": 0})
    data = root / "data"
    pairs = write_pose_pairs(scene, data / POSE_SCENE)
    log(f"[pose] box room {POSE_SEED}: {POSE_FRAMES} frames of {H}x{W} "
        f"rendered and written as PNGs, {len(pairs)} pairs "
        f"({len(POSE_ROTATIONS)} turned), in {time.perf_counter() - t0:.3f} s")

    jsonl = root / "pose.jsonl"
    env = dict(os.environ, SPNERF_DATA_PATH=str(data),
               SPNERF_CKPT_PATH=str(here / "demo"))
    cmd = [sys.executable, "-m", "spnerf_tpu_torch.eval.pose",
           "--config-path", str(POSE_CONFIG.relative_to(here)),
           "--json-out", str(jsonl)] + set_args(POSE_CUTS)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                          text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[pose] {' '.join(cmd)} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    res = json.loads(jsonl.read_text().splitlines()[-1])
    metrics = ("auc5", "auc10", "auc20", "precision", "matching_score")
    if res["num_pairs"] != len(pairs) or not all(
            0.0 <= res[k] <= 100.0 for k in metrics) \
            or sorted(res["ci95"]) != sorted(metrics):
        raise AssertionError(f"[pose] {res}")
    log(f"[pose] python3 -m spnerf_tpu_torch.eval.pose "
        f"({POSE_CONFIG.name}, --set {json.dumps(POSE_CUTS)}) in a child "
        f"process: {len(pairs)} pairs in {child_s:.3f} s with the "
        f"interpreter's start = {len(pairs) / child_s:.3f} pairs/s; "
        + "; ".join(f"{k} {res[k]:.2f} (95% CI [{res['ci95'][k][0]:.2f}, "
                    f"{res['ci95'][k][1]:.2f}])" for k in metrics)
        + f" ({card})")

    saved = (settings.DATA_PATH, settings.CKPT_PATH)
    settings.DATA_PATH, settings.CKPT_PATH = data, here / "demo"
    try:
        config = pose_config()
        infer = eval_pose.build_infer_fn(config, "cuda")
        t0 = time.perf_counter()
        again = eval_pose.estimate_pose_errors(
            config, infer, eval_pose.read_pairs(config))
        run_s = time.perf_counter() - t0
        child = {k: v for k, v in res.items() if k != "pretrained"}
        if json.loads(json.dumps(again)) != child:
            raise AssertionError(f"[pose] this process's results {again} "
                                 f"differ from the child's {child}")
        log(f"[pose] estimate_pose_errors in this process: {len(pairs)} "
            f"pairs in {run_s:.3f} s = {len(pairs) / run_s:.3f} pairs/s; "
            f"results equal to the child's ({card})")
        del infer
        pose_split(config, data, pairs[0], card)
        pose_estimator(scene, pairs, card)
        pose_small(data, pairs[:2], card)
    finally:
        settings.DATA_PATH, settings.CKPT_PATH = saved
    torch.cuda.empty_cache()


def pose_split(config: dict, data: Path, pair, card: str) -> None:
    """One pair's time by stage: inference (``superpoint_inference``) and
    descriptor sampling on the card by CUDA events, matching and RANSAC +
    ``recover_pose`` on the host; and the dense x8 upsample that
    ``superpoint_inference`` computes and the pose path never reads."""
    model = cli.model_for_inference(config, torch.device("cuda"))
    i, j, r0, r1 = pair
    size = config["data"]["resize"]
    images = [eval_pose.load_gray(data / POSE_SCENE / f"{f}.png", size, r)[0]
              for f, r in ((i, r0), (j, r1))]
    xs = [torch.from_numpy(np.ascontiguousarray(im / 255.0)).cuda()[
        None, ..., None] for im in images]
    outs = [superpoint_inference(model, x) for x in xs]
    infer_ms = sum(cuda_ms(lambda x=x: superpoint_inference(model, x), 5)
                   for x in xs)
    probs = [o["prob_heatmap_nms"][0].cpu().numpy() for o in outs]
    top_k = config["model"]["detector_head"]["top_k"]
    kpts = [eval_pose.top_keypoints_with_border(p, top_k) for p in probs]
    pts = [torch.from_numpy(k.astype(np.float32)).cuda() for k in kpts]

    def sample(o, p):
        return sample_descriptors(o["desc_raw"][0], p, model.config.grid_size)

    sample_ms = sum(cuda_ms(lambda o=o, p=p: sample(o, p), 5)
                    for o, p in zip(outs, pts))
    descs = [sample(o, p).cpu().numpy() for o, p in zip(outs, pts)]
    t0 = time.perf_counter()
    i0, i1 = eval_descriptor.mutual_nn_match(descs[0], descs[1])
    match_ms = (time.perf_counter() - t0) * 1e3
    mk0 = kpts[0][i0][:, ::-1].astype(np.float64)
    mk1 = kpts[1][i1][:, ::-1].astype(np.float64)
    K = camera_intrinsics((H, W), NERF_FOV).astype(np.float64)
    t0 = time.perf_counter()
    ret = eval_pose.recover_relative_pose(mk0, mk1, K, K, thresh=1.0)
    ransac_ms = (time.perf_counter() - t0) * 1e3
    desc_raw = outs[0]["desc_raw"]

    def dense():
        d = upsample_bicubic(desc_raw, model.config.grid_size)
        return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)

    dense_ms = cuda_ms(dense, 5)
    dense_mb = dense().numel() * 4 / 1e6
    log(f"[pose] one pair ({i}.png-{j}.png, {len(kpts[0])} / {len(kpts[1])} "
        f"keypoints, {len(mk0)} mutual matches, pose "
        f"{'found' if ret is not None else 'not found'}) split: inference "
        f"of both images {infer_ms:.3f} ms (the dense upsample below "
        f"included) and descriptor sampling "
        f"{sample_ms:.3f} ms on the card (CUDA events), matching "
        f"{match_ms:.3f} ms and RANSAC + recover_pose {ransac_ms:.3f} ms "
        f"on the host; the dense x8 upsample + normalization that "
        f"superpoint_inference computes and the pose path never reads: "
        f"{dense_ms:.3f} ms an image ({dense_mb:.1f} MB float32) ({card})")


def pose_estimator(scene: dict, pairs, card: str) -> None:
    """``recover_relative_pose`` on matches of every unturned pair from
    the scene's exact depth, against the scene's poses: as they are (the
    worst error at most POSE_MAX_DEG), then with POSE_NOISY's noise and
    outliers (each pair's RANSAC support against the true E's, and its
    errors against POSE_NOISY_DEG)."""
    poses = scene["poses"].astype(np.float64)
    K = camera_intrinsics(scene["rgb"].shape[1:3], NERF_FOV).astype(
        np.float64)
    norm_thresh = 2.0 / (K[0, 0] + K[1, 1])  # recover_relative_pose's
    for label, cuts in (("exact", {}), ("noisy", POSE_NOISY)):
        errs, secs, shares, supports = [], 0.0, [], []
        for k, (i, j, r0, r1) in enumerate(pairs):
            if r0 or r1:
                continue
            k0, k1 = exact_matches(scene, i, j, POSE_SEED + k, **cuts)
            t0 = time.perf_counter()
            ret = eval_pose.recover_relative_pose(k0, k1, K, K, thresh=1.0)
            secs += time.perf_counter() - t0
            if ret is None:
                raise AssertionError(f"[pose] no pose for pair {i}-{j}")
            R, t, inliers = ret
            T = np.linalg.inv(poses[j]) @ poses[i]
            errs.append((i, j, float(np.linalg.norm(T[:3, 3])))
                        + eval_pose.pose_errors_deg(T, R, t))
            shares.append(float(inliers.mean()))
            if label == "exact":
                continue
            n0, n1 = (eval_pose._normalized(p, K)[:, :2] for p in (k0, k1))
            _, mask = find_essential_mat(n0, n1, norm_thresh, prob=0.99999)
            true_E = eval_pose._cross_matrix(T[:3, 3]) @ T[:3, :3]
            held = sampson_errors(true_E[None], n0, n1)[0] <= np.float32(
                norm_thresh**2)
            supports.append(int(mask.sum()) / int(held.sum()))
            pin = POSE_NOISY_DEG[f"{i}-{j}"]
            if supports[-1] < POSE_NOISY_SUPPORT or max(
                    abs(a - b) for a, b in zip(errs[-1][3:], pin)) > \
                    POSE_NOISY_TOL:
                raise AssertionError(
                    f"[pose] noisy pair {i}-{j}: support {supports[-1]:.4f} "
                    f"of the true E's (at least {POSE_NOISY_SUPPORT}), "
                    f"errors {errs[-1][3:]} deg against {pin}")
        err_t = max(e[3] for e in errs)
        err_R = max(e[4] for e in errs)
        if label == "exact" and max(err_t, err_R) > POSE_MAX_DEG:
            raise AssertionError(f"[pose] estimator on exact matches: "
                                 f"rotation {err_R:.3f} deg, translation "
                                 f"{err_t:.3f} deg")
        log(f"[pose] find_essential_mat + recover_pose on {label} matches of "
            f"{len(errs)} pairs ({POSE_POINTS} points from the depth, "
            f"{json.dumps(cuts) if cuts else 'no noise, no outliers'}): "
            f"worst rotation error {err_R:.4f} deg, translation direction "
            f"{err_t:.4f} deg"
            + (f" (at most {POSE_MAX_DEG})" if label == "exact" else
               f" (each pair's within {POSE_NOISY_TOL} deg of the CPU's; "
               f"RANSAC support {min(supports):.4f}-{max(supports):.4f} of "
               f"the true E's, at least {POSE_NOISY_SUPPORT})")
            + f"; inlier share {min(shares):.3f}-{max(shares):.3f}; "
            f"{secs / len(errs) * 1e3:.1f} ms a pair on the host; per pair "
            "(i-j, baseline m, t deg, R deg): "
            + ", ".join(f"{i}-{j} {b:.3f} {et:.4f} {eR:.4f}"
                        for i, j, b, et, eR in errs) + f" ({card})")


def _near_tie_flips(got, want, d1, d2, gap=1e-4):
    """The mutual matches (i, j) found on one side only, each checked to
    sit where ``d1`` row i's or ``d2`` row j's nearest neighbour lies within
    ``gap`` (squared distance) of its second nearest."""
    d = ((d1[:, None] - d2[None]) ** 2).sum(-1)
    rows, cols = np.sort(d, 1), np.sort(d, 0)
    flips = set(map(tuple, got)) ^ set(map(tuple, want))
    for i, j in flips:
        if min(rows[i, 1] - rows[i, 0], cols[1, j] - cols[0, j]) >= gap:
            raise AssertionError(f"[pose-small] match ({i}, {j}) on one side")
    return len(flips)


def pose_small(data: Path, pairs, card: str) -> None:
    """Two pairs at 120 x 160 through the pose path's inference on the
    card and on the CPU plain path (same weights): dense heatmaps and the
    descriptors sampled at the CPU's keypoints within POSE_SMALL_TOL, the
    NMS'd keypoints equal away from near-ties, the mutual matches equal
    away from near-ties."""
    config = pose_config(**{"data.resize": list(POSE_SMALL[::-1])})
    model = cli.model_for_inference(config, torch.device("cuda"))
    cpu_model = copy.deepcopy(model).cpu()
    top_k = config["model"]["detector_head"]["top_k"]
    grid = model.config.grid_size
    worst, flips, apart = 0.0, 0, 0
    for i, j, r0, r1 in pairs:
        outs = {}
        for dev, m in (("cuda", model), ("cpu", cpu_model)):
            side = []
            for f, r in ((i, r0), (j, r1)):
                im = eval_pose.load_gray(data / POSE_SCENE / f"{f}.png",
                                         POSE_SMALL[::-1], r)[0]
                x = torch.from_numpy(np.ascontiguousarray(im / 255.0))
                side.append(superpoint_inference(m, x.to(dev)[None, ...,
                                                              None]))
            outs[dev] = side
        kpts = []
        for k in range(2):
            card_o, cpu_o = outs["cuda"][k], outs["cpu"][k]
            dense = cpu_o["prob_heatmap"][0].numpy()
            worst = max(worst, float((card_o["prob_heatmap"][0].cpu()
                                      - cpu_o["prob_heatmap"][0]).abs().max()))
            a = eval_pose.top_keypoints_with_border(
                card_o["prob_heatmap_nms"][0].cpu().numpy(), top_k)
            b = eval_pose.top_keypoints_with_border(
                cpu_o["prob_heatmap_nms"][0].numpy(), top_k)
            for y, x in {tuple(p) for p in a} ^ {tuple(p) for p in b}:
                win = dense[max(y - 4, 0):y + 5, max(x - 4, 0):x + 5]
                if np.sort(np.abs(win - dense[y, x]).ravel())[1] \
                        > POSE_SMALL_TOL:
                    raise AssertionError(f"[pose-small] keypoint ({y}, {x}) "
                                         "on one side")
                apart += 1
            pts = torch.from_numpy(b.astype(np.float32))
            d_card = sample_descriptors(card_o["desc_raw"][0], pts.cuda(),
                                        grid).cpu().numpy()
            d_cpu = sample_descriptors(cpu_o["desc_raw"][0], pts,
                                       grid).numpy()
            worst = max(worst, float(np.abs(d_card - d_cpu).max()))
            kpts.append((b, d_card, d_cpu))
        (b0, c0, p0), (b1, c1, p1) = kpts
        got = np.stack(eval_descriptor.mutual_nn_match(c0, c1), -1)
        want = np.stack(eval_descriptor.mutual_nn_match(p0, p1), -1)
        flips += _near_tie_flips(got, want, p0, p1)
    if worst > POSE_SMALL_TOL:
        raise AssertionError(f"[pose-small] card against CPU: {worst}")
    log(f"[pose-small] {len(pairs)} pairs at {POSE_SMALL[0]}x{POSE_SMALL[1]}"
        f", card against the CPU plain path: heatmaps and sampled "
        f"descriptors within {worst:.3e}, {apart} keypoints and {flips} "
        f"mutual matches on one side only (near-ties) ({card})")


def phase_quant(card: str) -> None:
    """[quant]: ``QuantizedSuperPoint`` from the full-width seeded
    SuperPoint, calibrated on 8 synthetic 480 x 640 images: ms a batch of
    8 and the im2col's share, the logit error against the BN-folded float
    model; then the card against the CPU at 2 x 64 x 80."""
    cfg = SuperPointConfig()
    model = init_superpoint(SEED + 61, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
    calib = synthetic_images(QUANT_BATCH, gen)
    t0 = time.perf_counter()
    q = quantization.QuantizedSuperPoint.build(cfg, model, calib)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = synthetic_images(QUANT_BATCH, gen)
    ms = cuda_ms(lambda: q(batch), QUANT_REPS)
    spans = []
    real = quantization.im2col

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args)
        end.record()
        spans.append((start, end))
        return out

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    quantization.im2col = timed
    try:
        start.record()
        got = q(batch)
        end.record()
    finally:
        quantization.im2col = real
    end.synchronize()
    im2col_ms = sum(a.elapsed_time(b) for a, b in spans)
    share = im2col_ms / start.elapsed_time(end)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        ref = folded_superpoint(fold_batch_norm(model), cfg,
                                torch.float32)(batch)
    scale = float(ref["logits"].abs().max()) + 1e-9
    err = float((got["logits"] - ref["logits"]).abs().max()) / scale
    if not err < QUANT_BOUND or not torch.isfinite(got["desc_raw"]).all():
        raise AssertionError(f"[quant] logit error {err} of the range")
    log(f"[quant] QuantizedSuperPoint (full width, seeded, calibrated on "
        f"{QUANT_BATCH} synthetic {H}x{W} images in {build_s:.3f} s): "
        f"{ms:.3f} ms a batch of {QUANT_BATCH} = "
        f"{QUANT_BATCH / ms * 1e3:.1f} frames/s; {len(spans)} im2cols "
        f"{im2col_ms:.3f} ms = {share:.1%} of a batch; logit error "
        f"{err:.4f} of the logit range against the BN-folded float32 model "
        f"(bound {QUANT_BOUND}) ({card})")

    small = synthetic_images(2, gen, QUANT_SMALL)
    cpu_q = quantization.QuantizedSuperPoint.build(
        cfg, copy.deepcopy(model).cpu(), None,
        act_scales={k: float(v) for k, v in q.act_scales.items()},
        device="cpu")
    sums, outs = {}, {}
    real = quantization.conv_int32
    for dev, qm in (("cuda", q), ("cpu", cpu_q)):
        sums[dev] = []

        def record(*args, out=sums[dev]):
            acc = real(*args)
            out.append(acc.cpu())
            return acc

        quantization.conv_int32 = record
        try:
            outs[dev] = qm(small.to(dev))
        finally:
            quantization.conv_int32 = real
    if len(sums["cuda"]) != len(sums["cpu"]) or not all(
            torch.equal(a, b) for a, b in zip(sums["cuda"], sums["cpu"])):
        raise AssertionError("[quant-small] int32 sums differ")
    over = 0.0
    for key, head in (("logits", "detector/convPb"),
                      ("desc_raw", "descriptor/convDb")):
        g, w = outs["cuda"][key].cpu(), outs["cpu"][key]
        s = w - cpu_q.params[head]["bias"]
        ulp = torch.exp2(torch.floor(torch.log2(s.abs().clamp_min(1e-30)))
                         - 7)
        over = max(over, float(((g - w).abs() / ulp).max()))
    if over > 1.0 + 1e-3:
        raise AssertionError(f"[quant-small] heads {over} bf16 ulps apart")
    log(f"[quant-small] 2x{QUANT_SMALL[0]}x{QUANT_SMALL[1]}, card against "
        f"the CPU plain path (the card's scales): {len(sums['cpu'])} int32 "
        f"sums equal, the heads within {over:.3f} bf16 ulps ({card})")
    del q, cpu_q, model
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if os.environ.get("PYTHONHASHSEED") != str(SEED):
        # Synthetic Shapes seeds each primitive's generator with
        # hash(primitive), which Python salts per process: rerun under a
        # fixed hash seed, so that [syn-gen]'s data, and its checks of
        # their points, are the same in every run.
        os.environ["PYTHONHASHSEED"] = str(SEED)
        os.execv(sys.executable, [sys.executable, *sys.argv])
    phase_build()
    card = phase_card()
    peaks = card_peaks(torch.cuda.get_device_name(0))
    log(f"[card] peaks used for bounds: {peaks[0] / 1e12:.0f} int8 TOP/s, "
        f"{peaks[3] / 1e12:.0f} bf16 TFLOP/s, {peaks[1] / 1e12:.2f} TB/s "
        f"({card})")

    cfg = SuperPointConfig(det_thresh=0.015)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    model = init_superpoint(SEED, cfg, device="cuda")
    requests = [synthetic_images(BATCH, gen) for _ in range(REQUESTS)]
    t0 = time.perf_counter()
    infer = build_inference(cfg, model, requests[0][:8], device="cuda",
                            top_k=TOP_K)
    log(f"[setup] built and calibrated on 8 images in "
        f"{time.perf_counter() - t0:.3f} s")

    calls = []
    with recorded_calls(calls):
        infer.serving(requests[0], softmax=True)
    torch.cuda.synchronize()
    rows = phase_kernels(calls, peaks)

    counts = phase_slice(infer, requests)
    phase_split(infer, requests[1], cfg)
    for row in rows:
        row["launches"] = counts.get(row["name"], 0)
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the path")
    phase_small_reference(infer.serving, cfg)
    # bf16, mixed and the per-layer routes: each a drive of its path with
    # the counters at 0 before it
    rows += phase_slice_routes(model, cfg, requests, peaks)
    phase_redesigned()
    phase_modes_small(infer.serving, cfg)
    # the row 8 kernel on the slice's sampling operands (its drive is the
    # three sets with the counters at 0), and the tie runs at the cut
    phase_ties(infer, requests, cfg)
    rows += phase_desc_sample(infer, requests[0], cfg, peaks)
    del infer, requests
    torch.cuda.empty_cache()

    # the H100 probes P1-P4, after the serving phases and while
    # torch.profiler still reports device time (late in the script it sees
    # none and device ms fall back to events); the probe modules' kernel
    # measurements are the drive, with the counters at 0 before it
    probe_rows = smoke_probes.phase_probes(peaks)

    # HPatches bundles through the parity path, from the JAX checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        hp_models = phase_hpatches(Path(tmp))
        phase_hpatches_small(*hp_models["descriptors"], Path(tmp) / "small")
    del hp_models
    torch.cuda.empty_cache()

    # homographic-adaptation export: each route is a drive of the main
    # path with the counters at 0 before it
    ha = ha_model()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    images = synthetic_images(HA_IMAGES, gen, (HA_H, HA_W)).cpu().numpy()
    ha_counts = collections.Counter()
    warp_calls, serving_calls = [], []
    for route, config in (
            ("(a) bf16 forward", export_config()),
            ("(b) int8 serving", export_config(serving="int8")),
            ("(c) int8 warps", export_config(compute_dtype="int8")),
            ("(d) mixed serving", export_config(serving="mixed"))):
        n = 8 if route.startswith("(c)") else HA_IMAGES  # (c): one batch
        ha_counts.update(phase_ha_export(ha, images[:n], route, config))
        image_warp, unwarp = phase_ha_split(
            ha, images, route, config,
            serving_calls if config["export"]["serving"] else None)
        if not config["export"]["serving"]:
            warp_calls += [("image warp", image_warp),
                           ("probability unwarp", unwarp)]
    ha_rows = (phase_warp_kernels(warp_calls, peaks)
               + phase_kernels(serving_calls, peaks))
    for row in ha_rows:
        row["launches"] = ha_counts.get(row["name"], 0)
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "HA export path")
    phase_ha_small(ha)
    rows += ha_rows
    del ha, images, warp_calls, serving_calls
    torch.cuda.empty_cache()

    # joint training: the 20-step run is the drive of the main path
    with tempfile.TemporaryDirectory() as tmp:
        train_counts, state, loader, step_call = phase_train(Path(tmp))
    phase_train_split(state, loader)
    del state
    torch.cuda.empty_cache()
    desc_rows = phase_desc_loss_kernels(
        [("training step", step_call),
         ("480x640", hinge_operands(*HINGE_SHAPES[1], SEED + 11, DEV))],
        peaks)
    for row in desc_rows:
        row["launches"] = train_counts.get(row["name"], 0)
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "training path")
    phase_train_small()
    rows += desc_rows
    torch.cuda.empty_cache()

    # data parallelism ([dist]): the sharded HA export and the DP step
    # drive rows 1-4, 9, 10 and 11 in the ranks
    dist_counts = phase_data_parallel()
    for row in ha_rows + desc_rows:
        row["dist_launches"] = dist_counts.get(row["name"], 0)
    torch.cuda.empty_cache()

    # NeRF pairs: label export and training on two procedural scenes; the
    # 20-step run is the drive of rows 10-11 on this path
    with tempfile.TemporaryDirectory() as tmp:
        saved_paths = (settings.DATA_PATH, settings.EXPER_PATH,
                       settings.CKPT_PATH)
        scenes = phase_nerf_scenes(Path(tmp))
        mp = phase_nerf_export(Path(tmp), scenes)
        phase_nerf_export_split(mp)
        room = scenes[NERF_SCENES[0]]
        del mp, scenes
        nerf_counts, state, nerf_call = phase_nerf_train(Path(tmp))
        phase_nerf_train_split(state)
        del state
        torch.cuda.empty_cache()
        # the task CLI on HPatches-layout sequences and on these scenes;
        # its training run drives rows 10-11 once more
        cli_counts = phase_cli(Path(tmp))
        settings.DATA_PATH, settings.EXPER_PATH, settings.CKPT_PATH = \
            saved_paths
    torch.cuda.empty_cache()
    nerf_rows = phase_desc_loss_kernels(nerf_hinge_cases(nerf_call), peaks)
    for row in nerf_rows:
        row["path"] = "nerf-train"
        row["launches"] = nerf_counts.get(row["name"], 0)
        row["cli_launches"] = cli_counts.get(row["name"], 0)
        if row["launches"] == 0 or row["cli_launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the NeRF "
                                 "training path or through the CLI")
    for row in desc_rows:
        row["path"] = "train"
    phase_nerf_small()
    rows += nerf_rows
    torch.cuda.empty_cache()

    # the NeRF scene pipeline (no kernel on its path): a full-width field
    # trained on box-room scene 0, its validation views rendered and
    # labelled, process_scene as the entry point, the hash field, and
    # card against CPU
    with tempfile.TemporaryDirectory() as tmp:
        saved_paths = (settings.DATA_PATH, settings.EXPER_PATH)
        settings.DATA_PATH = Path(tmp) / "data"
        settings.EXPER_PATH = Path(tmp) / "exper"
        field, field_cfg, pool = phase_nerf_field(room, peaks)
        phase_nerf_render(field, field_cfg, room, peaks)
        del field
        torch.cuda.empty_cache()
        phase_process_scene(Path(tmp), room)
        phase_hash_nerf(pool, field_cfg)
        del pool
        settings.DATA_PATH, settings.EXPER_PATH = saved_paths
    torch.cuda.empty_cache()
    phase_nerf_scene_small()
    del room

    # relative pose and int8 PTQ (no kernel on either path)
    with tempfile.TemporaryDirectory() as tmp:
        phase_pose(Path(tmp), card)
    phase_quant(card)

    # README's bootstrap from its own data through cli.main: the COCO
    # export drives rows 9 and 1-4, SuperPoint training rows 10-11, each
    # run with the counters at 0 before it
    with tempfile.TemporaryDirectory() as tmp:
        export_counts, boot_counts = smoke_data.phase_bootstrap(Path(tmp))
    torch.cuda.empty_cache()
    for row in ha_rows:
        row["coco_export_launches"] = export_counts.get(row["name"], 0)
    for row in desc_rows:
        row["coco_train_launches"] = boot_counts.get(row["name"], 0)

    # the demo's chain through the port, in a child: ctl_export drives row
    # 9, nerf_sp and ctl_sp rows 10-11, each leg with the counters at 0
    with tempfile.TemporaryDirectory() as tmp:
        demo_counts = smoke_demo.phase_demo(Path(tmp))
    for row in ha_rows + desc_rows:
        row["demo_launches"] = {leg: c[row["name"]] for leg, c in
                                demo_counts.items() if c.get(row["name"])}
    warp_rows = [r for r in ha_rows if r["name"].startswith("warp[")]
    if not all(r["demo_launches"] for r in desc_rows) or not any(
            r["demo_launches"] for r in warp_rows):
        raise AssertionError("rows 9-11 not all launched on the demo's "
                             "chain")

    # the fused tiny-NeRF serving renderer: the 10 renders per variant are
    # the drive of the main path
    fields = {width: load_field(width) for width in RENDER_FIELDS}
    o, d = orbit_rays(RENDER_RAYS)
    render_counts, render_ops = phase_render(fields, o, d)
    phase_render_quality(fields, render_ops.ivol)
    render_rows = phase_render_kernels(fields, render_ops, peaks)
    for row in render_rows:
        row["launches"] = render_counts.get(row["name"], 0)
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "render path")
    phase_render_small(fields)
    rows += render_rows + probe_rows

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
