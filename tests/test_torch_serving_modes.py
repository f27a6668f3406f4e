"""The port's serving graph in bf16 and mixed modes against the JAX
package on the CPU (fused mid and tail): bf16 and mixed at 2 x 32 x 64,
and bf16 at 2 x 32 x 56, where the mid drops to per-layer kernels by
itself (W % 16 != 0). Tolerances: see ``_serving_cases``."""

import pytest

import _serving_cases as C

CASES = {  # id: (mode, fused_mid, fused_tail, W)
    "bf16": ("bf16", True, True, 64),
    "mixed": ("mixed", True, True, 64),
    "bf16_w56": ("bf16", True, True, 56),
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


@pytest.mark.parametrize("mode", ["bf16", "mixed"])
def test_build_inference_end_to_end(variables, mode):
    C.check_build_inference(variables, mode, True, True)
