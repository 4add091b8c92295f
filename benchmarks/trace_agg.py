"""Profiler-trace aggregation: run a target computation under
`jax.profiler.trace`, then aggregate device-side op durations by fusion/op
name so optimisation effort lands on measured fractions.

    python benchmarks/trace_agg.py pit_step [N] [T]   # full PIT kernel step
    python benchmarks/trace_agg.py joint0   [N] [T]   # level-0 joint draws
    python benchmarks/trace_agg.py kalman_step        # headline MH step

Prints the top device ops by total duration (one JSON line each).
"""
import glob
import gzip
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _aggregate(log_dir, top=25):
    """Parse the .trace.json.gz and sum durations per op name on the GPU's
    stream rows (threads named "Stream ..." of the "/device:GPU:k"
    processes; every device thread when none is so named)."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                      recursive=True)
    assert paths, f"no trace under {log_dir}"
    path = max(paths, key=os.path.getmtime)
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    dev_pids, streams, dev_threads = set(), set(), set()
    for e in events:
        if e.get("ph") != "M":
            continue
        name = e.get("args", {}).get("name", "")
        if e.get("name") == "process_name" and "/device:" in name:
            dev_pids.add(e["pid"])
        elif e.get("name") == "thread_name" and name.startswith("Stream"):
            streams.add((e["pid"], e["tid"]))
    streams = {pt for pt in streams if pt[0] in dev_pids}
    agg = {}
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        if streams and (e["pid"], e.get("tid")) not in streams:
            continue
        name = e.get("name", "?")
        dur = e.get("dur", 0) / 1e3  # us -> ms
        agg[name] = agg.get(name, 0.0) + dur
        total += dur
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    return rows, total


def _run_and_aggregate(fn, *args, n_iter=3):
    import jax
    from aux_ssm_tpu.utils.profiling import trace

    f = jax.jit(fn)
    jax.block_until_ready(f(*args))
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir):
            for _ in range(n_iter):
                jax.block_until_ready(f(*args))
        rows, total = _aggregate(log_dir)
    print(json.dumps({"total_ms": round(total / n_iter, 2),
                      "n_iter": n_iter}))
    for name, ms in rows:
        print(json.dumps({"op": name[:120], "ms": round(ms / n_iter, 3),
                          "pct": round(100 * ms / total, 1)}))


def pit_stages(N, T):
    """Device time (not wall) for each PIT stage in isolation: the
    profiler's device total per stage, free of dispatch latency."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.special import logsumexp as lse_fn
    from aux_ssm_tpu.models import stochastic_volatility as sv
    from aux_ssm_tpu.kernels import csmc_independent as ci
    from aux_ssm_tpu.kernels import pit
    from aux_ssm_tpu.ops import stitching as st

    xs0, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, 1, T)
    M0, G0, Mt, Gt = sv.get_feynman_kac(ys, 0.0, 0.9, 2.0, 0.25)
    delta = 0.05 * jnp.ones((T,), jnp.float32)
    scale = jnp.sqrt(0.5 * delta)
    key = jax.random.key(2)
    key_u, key_inner = jax.random.split(key)
    u0 = xs0 + scale[:, None] * jax.random.normal(key_u, xs0.shape)
    proposals = ci.DiagonalGaussian(loc=u0, scale=scale)
    zeros_d = jnp.zeros_like(u0[0])
    gt = ci.AbsorbedGt(
        trans=Mt, pot=Gt,
        params=(Mt.params, Gt.params,
                (jnp.zeros_like(u0[1:]), jnp.zeros_like(u0[1:]),
                 jnp.ones_like(scale[1:]))))
    g0 = ci.AbsorbedG0(prior=M0, pot=G0, u=zeros_d, shift=zeros_d,
                       scale=jnp.ones_like(scale[0]))
    sample_key, resample_key = jax.random.split(key_inner)
    sample_keys = jax.random.split(sample_key, T)
    resample_keys = jax.random.split(resample_key, T)

    def propose(x_star):
        xs = jax.vmap(lambda m, k: m.sample(k, N))(proposals, sample_keys)
        xs = xs.at[:, 0].set(x_star)
        log_wts = jnp.zeros((T, N), dtype=x_star.dtype)
        log_wts = log_wts.at[0].add(g0(xs[0]))
        return xs, log_wts - lse_fn(log_wts, axis=1, keepdims=True)

    def stage(name, fn, *args):
        print(f'== {name}')
        _run_and_aggregate(fn, *args)

    stage("proposals", lambda x: propose(x)[0], xs0)
    xs, log_wts = jax.jit(propose)(xs0)

    params = gt.params
    fake = jax.tree.map(lambda z: jnp.full_like(z[:1], jnp.nan), params)
    params = jax.tree.map(lambda f, z: jnp.concatenate([f, z], axis=0),
                          fake, params)

    def tree_fn(xs_, lw_):
        sels, root = pit.run_stitch_tree(xs_, xs_, lw_, resample_keys, params,
                                         gt, N, include_root=True)
        flat = [s for s in sels if s is not None]
        return (sum(jnp.sum(L) + jnp.sum(R) for L, R, _ in flat)
                + jnp.sum(root[0]) + jnp.sum(root[1]))

    stage("tree", tree_fn, xs, log_wts)

    P = T // 2
    lefts = 2 * jnp.arange(P)
    rights = lefts + 1
    params_r = jax.tree.map(lambda z: z[rights], params)
    node_keys = resample_keys[rights]

    def factors0(xl_, xr_):
        rf, cf, rb, cb = jax.vmap(gt.pairwise_factors)(xl_, xr_, params_r)
        return rf.sum() + cf.sum() + rb.sum() + cb.sum()

    stage("factors0", factors0, xs[lefts], xs[rights])
    rf, cf, rb, cb = jax.jit(lambda a, b: jax.vmap(gt.pairwise_factors)(
        a, b, params_r))(xs[lefts], xs[rights])
    rb = rb + log_wts[lefts]
    cb = cb + log_wts[rights]
    stage("masses0", lambda a, b, c: st.block_masses(a, b, c), rf, cf, cb)
    Lb = jax.jit(st.block_masses)(rf, cf, cb)
    key_rows = jax.vmap(lambda k: jax.random.fold_in(k, 0))(node_keys)
    u_rows = jax.vmap(lambda k: jax.random.uniform(k, (N,)))(key_rows)

    def draws0_joint(ur, rb_, lb, rf_, cf_, cb_):
        rows, blocks, rfs = st.joint_rowblock_draws(ur, rb_, lb, row_feat=rf_)
        cols = st.within_block_cols(jnp.int32(777), blocks, rfs, cf_, cb_)
        return rows + cols

    stage("draws0_joint", draws0_joint, u_rows, rb, Lb, rf, cf, cb)


def pit_step(N, T):
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import stochastic_volatility as sv
    from aux_ssm_tpu.kernels import csmc_independent as ci

    xs0, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, 1, T)
    M0, G0, Mt, Gt = sv.get_feynman_kac(ys, 0.0, 0.9, 2.0, 0.25)
    init, kernel = ci.get_kernel(M0, G0, Mt, Gt, N, parallel=True)
    delta = 0.05 * jnp.ones((T,), jnp.float32)
    state = init(xs0)
    _run_and_aggregate(lambda s: kernel(jax.random.key(1), s, delta).x, state)


def joint0(N, T):
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.ops import stitching as st

    P = T // 2
    nb = N // 128
    key = jax.random.key(0)
    rb = jax.random.normal(jax.random.fold_in(key, 0), (P, N))
    Lb = jax.random.normal(jax.random.fold_in(key, 1), (P, N, nb))
    rf = jax.random.normal(jax.random.fold_in(key, 2), (P, N, 1))
    cf = jax.random.normal(jax.random.fold_in(key, 3), (P, N, 1))
    cb = jax.random.normal(jax.random.fold_in(key, 4), (P, N))
    u = jax.random.uniform(jax.random.fold_in(key, 5), (P, N))

    def fn(u_, rb_, Lb_, rf_, cf_, cb_):
        rows, blocks, rfs = st.joint_rowblock_draws(u_, rb_, Lb_, row_feat=rf_)
        cols = st.within_block_cols(jnp.int32(123), blocks, rfs, cf_, cb_)
        return rows + cols

    _run_and_aggregate(fn, u, rb, Lb, rf, cf, cb)


def kalman_step():
    import jax
    import jax.numpy as jnp
    import __graft_entry__ as graft
    from aux_ssm_tpu.kernels.kalman import get_kernel

    T, dx = 1024, 16
    dyn, obs, target_fn = graft._build_lgssm_model(T, dx)
    init, kernel = get_kernel(dyn, obs, target_fn, parallel=True)
    state = init(jnp.zeros((T, dx), jnp.float32))
    delta = jnp.float32(0.05)
    _run_and_aggregate(lambda s: kernel(jax.random.key(1), s, delta).x, state)


if __name__ == "__main__":
    case = sys.argv[1] if len(sys.argv) > 1 else "pit_step"
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    T = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    if case == "pit_step":
        pit_step(N, T)
    elif case == "pit_stages":
        pit_stages(N, T)
    elif case == "joint0":
        joint0(N, T)
    elif case == "kalman_step":
        kalman_step()
    else:
        raise SystemExit(f"unknown case {case}")
