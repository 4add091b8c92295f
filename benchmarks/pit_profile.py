"""Stage-level decomposition of the PIT-cSMC step at the large-N config
(T=1024, N=4096, SV D=1 — the `csmc_speed.py pit4096` case).

Times each stage of `kernels/pit._pit_csmc` in isolation (single-dispatch,
jitted, outputs consumed) so optimisation effort lands where the time is:

  full        one whole kernel step (reference point)
  proposals   T x N proposal sampling + weight init
  tree        run_stitch_tree (all levels: factors, masses, draws, bounds)
  masses0     level-0 block-mass pass alone (P=512, N, k=1)
  draws0      level-0 joint draws (rows, blocks, columns) alone
  factors0    level-0 pairwise-factor build + boundary gathers alone
  genealogy   selection-map resolution + final trajectory gather

`python benchmarks/pit_profile.py [N]` (default 4096) prints one JSON line
per stage.
"""
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
T = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
N_ITER = 5


def _timeit(fn, *args):
    from aux_ssm_tpu.utils.profiling import timeit_ms
    return timeit_ms(fn, *args, n_iter=N_ITER)


def main():
    import jax
    import jax.numpy as jnp
    from aux_ssm_tpu.models import stochastic_volatility as sv
    from aux_ssm_tpu.kernels import csmc_independent as ci
    from aux_ssm_tpu.kernels import pit

    xs0, ys = sv.get_data(jax.random.key(0), 0.0, 0.9, 2.0, 0.25, 1, T)
    M0, G0, Mt, Gt = sv.get_feynman_kac(ys, 0.0, 0.9, 2.0, 0.25)
    init, kernel = ci.get_kernel(M0, G0, Mt, Gt, N, parallel=True)
    delta = 0.05 * jnp.ones((T,), jnp.float32)
    state = init(xs0)

    report = {}
    report["full"] = _timeit(lambda s, k: kernel(k, s, delta).x,
                             state, jax.random.key(1))

    # Rebuild the kernel's internals at a fixed u to time the stages.
    scale = jnp.sqrt(0.5 * delta)
    key = jax.random.key(2)
    key_u, key_inner = jax.random.split(key)
    u = state.x + scale[:, None] * jax.random.normal(key_u, state.x.shape)
    proposals = ci.DiagonalGaussian(loc=u, scale=scale)
    zeros_d = jnp.zeros_like(u[0])
    gt = ci.AbsorbedGt(
        trans=Mt, pot=Gt,
        params=(Mt.params, Gt.params,
                (jnp.zeros_like(u[1:]), jnp.zeros_like(u[1:]),
                 jnp.ones_like(scale[1:]))),
    )
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
        from jax.scipy.special import logsumexp
        return xs, log_wts - logsumexp(log_wts, axis=1, keepdims=True)

    report["proposals"] = _timeit(lambda x: propose(x)[0].sum(), state.x)
    xs, log_wts = jax.jit(propose)(state.x)

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

    report["tree"] = _timeit(tree_fn, xs, log_wts)

    def geneal_fn(xs_, lw_):
        sels, root = pit.run_stitch_tree(xs_, xs_, lw_, resample_keys, params,
                                         gt, N, include_root=True)
        idx0 = pit._root_init(root, T, N)
        idx = pit.resolve_genealogy(sels, idx0, T, N)
        return jnp.take_along_axis(xs_, idx[:, None, None], axis=1)[:, 0]

    report["tree+genealogy"] = _timeit(geneal_fn, xs, log_wts)

    # Level-0 shapes: P = T // 2 nodes on the (t, t+1) boundaries.
    P = T // 2
    lefts = 2 * jnp.arange(P)
    rights = lefts + 1
    xl = xs[lefts]
    xr = xs[rights]
    lw_l = log_wts[lefts]
    lw_r = log_wts[rights]
    params_r = jax.tree.map(lambda z: z[rights], params)
    node_keys = resample_keys[rights]

    def factors0(xl_, xr_):
        rf, cf, rb, cb = jax.vmap(gt.pairwise_factors)(xl_, xr_, params_r)
        return rf.sum() + cf.sum() + rb.sum() + cb.sum()

    report["factors0"] = _timeit(factors0, xl, xr)

    rf, cf, rb, cb = jax.jit(lambda a, b: jax.vmap(gt.pairwise_factors)(
        a, b, params_r))(xl, xr)
    rb = rb + lw_l
    cb = cb + lw_r

    from aux_ssm_tpu.ops import stitching as st
    from aux_ssm_tpu.ops.take import take_rows
    report["masses0"] = _timeit(lambda a, b, c: st.block_masses(a, b, c).sum(),
                                rf, cf, cb)
    Lb = jax.jit(st.block_masses)(rf, cf, cb)

    key_rows = jax.vmap(lambda k: jax.random.fold_in(k, 0))(node_keys)
    u_rows = jax.vmap(lambda k: jax.random.uniform(k, (N,)))(key_rows)
    seed = jnp.int32(12345)

    # Joint-draw decomposition (the default engine).
    def joint0(ur, rb_, lb):
        rows, blocks = st.joint_rowblock_draws(ur, rb_, lb)
        return rows.sum() + blocks.sum()

    report["joint0"] = _timeit(joint0, u_rows, rb, Lb)
    rows_j, blocks_j, rf_sel = jax.jit(
        lambda a, b, c, d: st.joint_rowblock_draws(a, b, c, row_feat=d)
    )(u_rows, rb, Lb, rf)
    report["take_rf0"] = _timeit(lambda a, b: take_rows(a, b).sum(), rf, rows_j)
    report["wbc0"] = _timeit(
        lambda b, r, c, cbb: st.within_block_cols(seed, b, r, c, cbb).sum(),
        blocks_j, rf_sel, cf, cb)

    def draws0_joint(ur, rb_, lb, rf_, cf_, cb_):
        rows, blocks, rfs = st.joint_rowblock_draws(ur, rb_, lb, row_feat=rf_)
        cols = st.within_block_cols(seed, blocks, rfs, cf_, cb_)
        return rows.at[:, 0].set(0).sum() + cols.at[:, 0].set(0).sum()

    report["draws0_joint"] = _timeit(draws0_joint, u_rows, rb, Lb, rf, cf, cb)

    for name, ms in report.items():
        print(json.dumps({"stage": name, "ms": round(ms, 2), "N": N, "T": T}),
              flush=True)


if __name__ == "__main__":
    main()
