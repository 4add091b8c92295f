"""Profiling helpers (SURVEY §5: the reference times with io_callback
tic/toc pairs; the build exposes `jax.profiler` traces + a host-side timer).
"""
import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir):
    """Capture a jax.profiler trace viewable in TensorBoard/XProf:

        with profiling.trace("/tmp/trace"):
            run_chain(...)
    """
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timeit_ms(fn, *args, n_iter=5):
    """Median wall-clock of the jitted `fn(*args)` in ms, each call ended by
    `jax.block_until_ready`; the first (compiling) call is not timed."""
    f = jax.jit(fn)
    jax.block_until_ready(f(*args))
    times = []
    for _ in range(n_iter):
        tic = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - tic)
    times.sort()
    return times[len(times) // 2] * 1e3


@contextlib.contextmanager
def timer(label="block", sync=None):
    """Host wall-clock timer; pass `sync` (an array/pytree) to block on
    device completion before stopping the clock."""
    tic = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        if sync is not None:
            jax.block_until_ready(sync)
        box["seconds"] = time.perf_counter() - tic
        box["label"] = label
