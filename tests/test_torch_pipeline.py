"""Port parity: ``data/pipeline.py``'s ``DataPipeline``.

The reference's shutdown regression pins (``tests/test_fleet.py``: close
joins a worker blocked on a full queue, ``next`` after ``close`` or after
a worker error raises instead of hanging, exhaustion keeps raising
``StopIteration``) and ``tests/test_data.py``'s prefetch test, on the
port; then ``device=`` placement on the CPU: the batches are the JAX
pipeline's, bit for bit, as tensors on the device. (Placement on the
card, through pinned memory and the pipeline's own stream, is a ``gpu``
test in ``test_torch_gpu.py``.)
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import DataPipeline as JDataPipeline  # noqa: E402
from repro.data.synthetic import lm_batches as j_lm_batches  # noqa: E402
from repro_torch.data import DataPipeline, lm_batches  # noqa: E402


def test_pipeline_close_joins_worker_with_full_queue():
    def endless():
        while True:
            yield {"x": np.zeros(4)}

    pipe = DataPipeline(endless(), prefetch=1)
    next(pipe)                         # worker now refilling a full queue
    t0 = time.monotonic()
    pipe.close()
    assert time.monotonic() - t0 < 5.0
    assert not pipe._thread.is_alive()


def test_pipeline_next_after_close_raises_not_hangs():
    pipe = DataPipeline(iter([{"x": np.zeros(2)}]), prefetch=1)
    pipe.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(pipe)


def test_pipeline_next_after_worker_error_raises_not_hangs():
    def boom():
        raise ValueError("source died")
        yield  # pragma: no cover

    pipe = DataPipeline(boom())
    with pytest.raises(ValueError):
        next(pipe)
    with pytest.raises(RuntimeError, match="worker raised ValueError"):
        next(pipe)


def test_pipeline_exhaustion_keeps_raising_stopiteration():
    pipe = DataPipeline(iter([{"x": np.zeros(2)}]))
    assert len(list(pipe)) == 1
    with pytest.raises(StopIteration):          # iterator protocol holds
        next(pipe)


def test_pipeline_prefetch_and_errors():
    pipe = DataPipeline(lm_batches(2, 8, 64, seed=0, n_steps=3))
    assert len(list(pipe)) == 3

    def boom():
        yield {"x": np.zeros(2)}
        raise ValueError("source died")

    pipe = DataPipeline(boom())
    next(pipe)
    with pytest.raises(ValueError):
        next(pipe)


def test_device_placement_equals_jax_pipeline_batches():
    got = list(DataPipeline(lm_batches(3, 8, 64, seed=5, n_steps=4),
                            device="cpu"))
    want = list(JDataPipeline(j_lm_batches(3, 8, 64, seed=5, n_steps=4)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
