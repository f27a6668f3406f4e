"""Reference PyTorch checkpoint -> the port's SuperPoint
(``spnerf_tpu/tools/import_torch_weights.py``).

The reference ships and writes state dicts with the layout
(reference models/model_utils/VGG_Backbone.py:40-58, heads.py:11-15,55,
SuperPoint.py:9-15):

    backbone.block_{1..8}.conv2d.{weight,bias}
    backbone.block_{1..8}.norm.{weight,bias,running_mean,running_var}
    detector_head.conv{Pa,Pb}.{conv2d,norm}.*
    descriptor_head.conv{Da,Db}.{conv2d,norm}.*

and loads them by *partial merge*: only keys present in the target
model, with the same shape, are copied (engine.py:86-90), which is how
MagicPoint weights seed a SuperPoint model. The port's module keeps the
flax paths with torch's layouts, so the mapping renames and copies:

    backbone.block_i.conv2d.*   ->  backbone.block{i}.Conv_0.*  (OIHW)
    *.norm.{weight,bias}        ->  *.BatchNorm_0.{weight,bias}
    *.norm.running_{mean,var}   ->  *.BatchNorm_0.running_{mean,var}

Usage (CLI), writing a checkpoint that ``restore_pretrained`` reads:
    python -m spnerf_tpu_torch.tools.import_torch_weights model.pth \\
        out.ckpt [--model-name superpoint]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from spnerf_tpu_torch.models.superpoint import (
    SuperPoint,
    SuperPointConfig,
    init_superpoint,
)
from spnerf_tpu_torch.train.loop import (
    checkpoint_payload,
    create_train_state,
    model_batch_stats,
    model_params,
    partial_restore,
)

# reference module path -> the port's module path
_BLOCKS = (
    [(f"backbone.block_{i}", f"backbone.block{i}") for i in range(1, 9)]
    + [
        ("detector_head.convPa", "detector.convPa"),
        ("detector_head.convPb", "detector.convPb"),
        ("descriptor_head.convDa", "descriptor.convDa"),
        ("descriptor_head.convDb", "descriptor.convDb"),
    ]
)
_PARAMS = (("conv2d.weight", "Conv_0.weight"), ("conv2d.bias", "Conv_0.bias"),
           ("norm.weight", "BatchNorm_0.weight"),
           ("norm.bias", "BatchNorm_0.bias"))
_STATS = (("norm.running_mean", "BatchNorm_0.running_mean"),
          ("norm.running_var", "BatchNorm_0.running_var"))


def torch_state_dict_to_port(state_dict) -> dict:
    """A reference-layout state dict (tensors or ndarrays) -> {"params",
    "batch_stats"} of float32 CPU tensors under the port's paths; absent
    blocks are skipped (a MagicPoint dict without a descriptor head stays
    partial)."""
    def arr(key):
        v = state_dict.get(key)
        if v is None:
            return None
        if torch.is_tensor(v):
            return v.detach().cpu().float().clone()
        return torch.from_numpy(np.array(v, np.float32))

    params: dict = {}
    stats: dict = {}
    for ref, port in _BLOCKS:
        for group, names in ((params, _PARAMS), (stats, _STATS)):
            for ref_name, port_name in names:
                v = arr(f"{ref}.{ref_name}")
                if v is not None:
                    group[f"{port}.{port_name}"] = v
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint(path: str | Path) -> dict:
    """Load a .pth checkpoint (the reference's {'iteration',
    'model_state_dict'} wrapper, train.py:137-139, or a bare state dict)
    and map it with ``torch_state_dict_to_port``."""
    payload = torch.load(str(path), map_location="cpu", weights_only=True)
    state_dict = payload.get("model_state_dict", payload) \
        if isinstance(payload, dict) else payload
    return torch_state_dict_to_port(state_dict)


def import_into(model: SuperPoint, port_weights: dict) -> list:
    """Partial-merge mapped weights into ``model`` in place (engine.py:
    86-90 semantics: path and shape matches only); returns the restored
    paths."""
    return (partial_restore(model_params(model), port_weights["params"])
            + partial_restore(model_batch_stats(model),
                              port_weights["batch_stats"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("torch_ckpt", help=".pth file in reference layout")
    ap.add_argument("out", help="output .ckpt (the port's checkpoint format)")
    ap.add_argument("--model-name", default="superpoint",
                    choices=["superpoint", "magicpoint"])
    args = ap.parse_args(argv)

    model = init_superpoint(0, SuperPointConfig(model_name=args.model_name),
                            device="cpu")
    restored = import_into(model, load_torch_checkpoint(args.torch_ckpt))
    state = create_train_state(model, 1e-3)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(checkpoint_payload(state), out)
    print(f"wrote {out} ({len(restored)} tensors imported)")


if __name__ == "__main__":
    main()
