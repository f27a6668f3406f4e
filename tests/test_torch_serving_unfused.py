"""The port's serving graph on its per-layer route against the JAX
package on the CPU: int8 with neither the fused mid nor the fused tail
and mixed without the fused tail at 2 x 32 x 64, and int8 at
2 x 32 x 40, a width the fused mid cannot take (W % 16 != 0), where the
graph drops to per-layer kernels by itself. Tolerances: see
``_serving_cases``."""

import pytest
import torch

import _serving_cases as C

CASES = {  # id: (mode, fused_mid, fused_tail, W)
    "int8_unfused": ("int8", False, False, 64),
    "mixed_unfused_tail": ("mixed", True, False, 64),
    "int8_w40": ("int8", True, True, 40),
}


@pytest.fixture(scope="module")
def variables():
    return C.jax_variables()


@pytest.fixture(scope="module", params=list(CASES))
def case(request, variables):
    ref = C.jax_case(variables, *CASES[request.param])
    return ref, C.port_case(ref)


def test_outputs_match_jax(case):
    ref, (out, _) = case
    C.check_outputs(ref, out)


def test_keypoints_match_jax(case):
    ref, (_, dets) = case
    C.check_keypoints(ref, dets)


def test_descriptors_match_jax(case):
    ref, (out, _) = case
    C.check_descriptors(ref, out)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_build_inference_without_fused_tail(variables, mode):
    C.check_build_inference(variables, mode, False, False)


def test_unfused_route_launches_per_layer_wrappers(monkeypatch):
    """With both flags off, every layer goes through its own wrapper:
    blocks 3-5 ``packed_conv3x3``, block 6-8 and the heads' 3x3 convs
    ``conv3x3``, the heads' 1x1 convs ``dot_bias_act``."""
    from spnerf_tpu_torch.models.superpoint import (
        SuperPointConfig,
        init_superpoint,
    )
    from spnerf_tpu_torch.ops import serving

    calls = []
    for name in ("packed_conv3x3", "conv3x3", "dot_bias_act",
                 "double_conv3x3", "double_packed_conv3x3", "head"):
        fn = getattr(serving, name)
        monkeypatch.setattr(serving, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    model = init_superpoint(0, SuperPointConfig(), device="cpu")
    x = torch.rand(1, 16, 16, 1)
    sp = serving.ServingSuperPoint.build(SuperPointConfig(), model, x,
                                         fused_mid=False, fused_tail=False,
                                         device="cpu")
    sp(x)
    assert calls == ["packed_conv3x3"] * 3 + ["conv3x3"] * 4 + [
        "dot_bias_act", "conv3x3", "dot_bias_act"]
