"""cv2's global generator in the port (``spnerf_tpu_torch/eval/cv_rng.py``)
follows OpenCV's per-thread rule, held against ``cv2.randu`` on this
host: a new thread's first draws are a fresh process's, whatever the
main thread drew or seeded before; ``set_rng_seed`` (``cv2.setRNGSeed``)
restarts the calling thread's generator alone; ``randu`` with no
generator draws from the calling thread's."""

import threading

import numpy as np
import pytest

from spnerf_tpu_torch.eval import cv_rng

cv2 = pytest.importorskip("cv2")


def _draws(low=0, high=255, n=64):
    """(cv2's, the port's) next ``n`` draws in the calling thread."""
    want, got = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
    cv2.randu(want, low, high)
    cv_rng.randu(got, low, high)
    return want, got


def _in_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def _assert_same(pair):
    np.testing.assert_array_equal(pair[1], pair[0])


def test_threads_start_fresh_and_seed_their_own():
    fresh = _in_thread(_draws)
    _assert_same(fresh)
    assert cv_rng.CvRNG(0xFFFFFFFF).state == _in_thread(
        lambda: cv_rng.the_rng().state)
    # after the main thread has drawn (from one seed: other tests of this
    # process may have drawn from one of the two alone)
    cv2.setRNGSeed(123)
    cv_rng.set_rng_seed(123)
    _assert_same(_draws())
    _assert_same(_draws(3, 200))
    after_draws = _in_thread(_draws)
    _assert_same(after_draws)
    np.testing.assert_array_equal(after_draws[1], fresh[1])
    # after the main thread has seeded
    cv2.setRNGSeed(5)
    cv_rng.set_rng_seed(5)
    seeded_main = _draws()
    _assert_same(seeded_main)
    after_seed = _in_thread(_draws)
    _assert_same(after_seed)
    np.testing.assert_array_equal(after_seed[1], fresh[1])
    # a seed set in another thread moves only that thread's generator
    main_state = cv_rng.the_rng().state

    def seed_and_draw():
        cv2.setRNGSeed(9)
        cv_rng.set_rng_seed(9)
        return _draws()

    seeded_thread = _in_thread(seed_and_draw)
    _assert_same(seeded_thread)
    assert not np.array_equal(seeded_thread[1], fresh[1])
    assert cv_rng.the_rng().state == main_state
    _assert_same(_draws())


def test_concurrent_threads_each_draw_their_own_stream():
    """Four threads drawing at once: each gets a fresh process's stream,
    as in cv2."""
    barrier = threading.Barrier(4)
    results = [None] * 4

    def run(k):
        barrier.wait()
        results[k] = [_draws(0, 250, 16) for _ in range(5)]

    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for runs in results:
        for pair in runs:
            _assert_same(pair)
        for a, b in zip(runs, results[0]):
            np.testing.assert_array_equal(a[1], b[1])
