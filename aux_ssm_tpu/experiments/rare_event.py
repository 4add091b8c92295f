"""Rare-event experiment driver (reference `examples/rare_event/
experiment.py` capability): grid over (rho, r2), batched chains, ESS and
moment accuracy vs the closed-form conditionals.

Design: the reference vmaps 8 chains per grid cell but still
recompiles per cell (`experiment.py:76-77,189-196`); here the WHOLE sweep —
every (rho, r2) cell times every chain — is one vmapped kernel inside one
compiled program. The model builders take traced `rho`/`r2`, so the grid is
just a batch axis; per-cell deltas adapt elementwise. With a device mesh the
flat cell-chain axis is sharded over the `chains` mesh axis.

    python -m aux_ssm_tpu.experiments.rare_event --grid-size 5 --n-chains 8
"""
import chex
import jax
import jax.numpy as jnp
import numpy as np

from ..models import rare_event as re_model
from ..utils.ess import effective_sample_size, potential_scale_reduction
from . import cli
from .runner import run_chain


def make_batched_kernel(style, args):
    """(init, kernel) over a flat batch of chains with per-chain (rho, r2).

    `kernel(key, state, delta)` derives one fold_in key per chain and vmaps
    the per-cell kernel, so every cell of the sweep lives in one program.
    """

    def one_step(key, x, delta, rho, r2):
        if style.startswith("kalman"):
            init, kern = re_model.get_kalman_kernel(
                args.y, rho, r2, args.T, args.parallel, gradient=args.gradient)
            state = init(x)
        elif style == "csmc":
            init, kern = re_model.get_csmc_kernel(
                args.y, rho, r2, args.T, args.n_particles,
                backward=args.backward, parallel=args.parallel,
                gradient=args.gradient)
            state = init(x)
        elif style == "csmc-guided":
            init, kern = re_model.get_guided_csmc_kernel(
                args.y, rho, r2, args.T, args.n_particles,
                backward=args.backward, gradient=args.gradient)
            state = init(x)
        else:
            raise ValueError(f"unknown style {style!r}")
        return kern(key, state, delta)

    def kernel(key, state, delta):
        n = state.x.shape[0]
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
        inner = jax.vmap(one_step)(keys, state.x, delta, state.rho, state.r2)
        return GridState(x=inner.x, updated=inner.updated,
                         rho=state.rho, r2=state.r2)

    return kernel


@chex.dataclass
class GridState:
    """Batched sampler state carrying each chain's (rho, r2) cell."""
    x: chex.Array        # (M, T, 1)
    updated: chex.Array  # (M,) kalman-style or (M, T) csmc-style
    rho: chex.Array      # (M,)
    r2: chex.Array       # (M,)


def run_grid(args):
    G, C = args.grid_size, args.n_chains
    rhos = np.linspace(0.0, 0.999, G)
    r2s = np.logspace(-3, 0, G)
    rho_grid, r2_grid = [z.ravel() for z in np.meshgrid(rhos, r2s, indexing="ij")]
    M = G * G * C
    RHO = jnp.asarray(np.repeat(rho_grid, C))
    R2 = jnp.asarray(np.repeat(r2_grid, C))

    key = jax.random.key(args.seed)
    init_key, run_key = jax.random.split(key)
    init_keys = jax.vmap(lambda i: jax.random.fold_in(init_key, i))(jnp.arange(M))
    x0 = jax.vmap(
        lambda k, rho, r2: re_model.init_x(k, args.y, rho, r2, args.T,
                                           args.parallel)
    )(init_keys, RHO, R2)

    is_csmc = args.style.startswith("csmc")
    if is_csmc:
        upd0 = jnp.zeros((M, args.T), dtype=bool)
        delta0 = args.delta_init * jnp.ones((M, args.T))
    else:
        upd0 = jnp.zeros((M,), dtype=bool)
        delta0 = args.delta_init * jnp.ones((M,))
    state0 = GridState(x=x0, updated=upd0, rho=RHO, r2=R2)

    # Optional chain-axis meshing: the whole flat cell-chain batch is placed
    # on the 'chains' mesh axis; GSPMD then executes the one-program sweep
    # data-parallel across devices.
    mesh_n = getattr(args, "mesh_chains", 0)
    if mesh_n and M % mesh_n:
        raise ValueError(
            f"--mesh-chains {mesh_n} does not divide the flat cell-chain "
            f"batch (grid^2 * n_chains = {M}); pick a divisor or adjust "
            f"--n-chains — refusing to silently run unsharded.")
    if mesh_n:
        from ..config import MeshConfig
        from ..parallel.chains import shard_chains
        mesh = MeshConfig(axis_names=("chains",), axis_sizes=(mesh_n,)).build()
        state0 = shard_chains(mesh, state0)
        delta0 = shard_chains(mesh, delta0)

    kernel = make_batched_kernel(args.style, args)
    cfg = cli.run_config(args, verbose=False)
    res = run_chain(run_key, kernel, state0, cfg, collect_samples=True,
                    delta_init=delta0,
                    checkpoint_dir=getattr(args, "checkpoint_dir", None),
                    checkpoint_every=getattr(args, "checkpoint_every", 0))

    s = np.asarray(res.samples)                    # (n, M, T, 1)
    s = s.reshape(s.shape[0], G * G, C, args.T)
    acc = np.asarray(jnp.mean(res.stats.accept_cum.reshape(G * G, C, -1),
                              axis=(1, 2)))
    t_per_cell = res.sampling_time                 # shared program

    rows = []
    for ci in range(G * G):
        rho, r2 = float(rho_grid[ci]), float(r2_grid[ci])
        (m0c, v0c), (mTc, vTc) = re_model.conditional_moments(
            args.y, rho, r2, args.T)
        x0s = s[:, ci, :, 0]                       # (n, C)
        xTs = s[:, ci, :, -1]
        ess_0 = float(sum(effective_sample_size(x0s[:, c]) for c in range(C)))
        ess_T = float(sum(effective_sample_size(xTs[:, c]) for c in range(C)))
        # Between-chain health per cell (chains axis is C): split-R-hat on
        # the endpoint coordinates; NaN for single-chain runs.
        rhat_0 = (float(potential_scale_reduction(x0s.T)) if C >= 2
                  else float("nan"))
        rhat_T = (float(potential_scale_reduction(xTs.T)) if C >= 2
                  else float("nan"))
        rows.append(dict(
            rho=rho, r2=r2,
            err_mean_0=(x0s.mean() - m0c) ** 2 / v0c,
            err_std_0=(x0s.std() - np.sqrt(v0c)) / np.sqrt(v0c),
            err_mean_T=(xTs.mean() - mTc) ** 2 / vTc,
            err_std_T=(xTs.std() - np.sqrt(vTc)) / np.sqrt(vTc),
            ess_0=ess_0, ess_T=ess_T, rhat_0=rhat_0, rhat_T=rhat_T,
            acc=float(acc[ci]), time=t_per_cell,
        ))
    return rows, res


def main(argv=None):
    p = cli.base_parser("Rare-event experiment")
    p.add_argument("--T", type=int, default=2)
    p.add_argument("--y", type=float, default=5.0)
    p.add_argument("--grid-size", type=int, default=10)
    p.add_argument("--figures-dir", type=str, default=None,
                   help="write heatmap figure + summary CSV here")
    p.set_defaults(n_chains=8)
    args = p.parse_args(argv)
    cli.apply_backend(args)

    rows, _ = run_grid(args)
    for r in rows:
        print(f"rho={r['rho']:.2f} r2={r['r2']:.3g}: acc={r['acc']:.2f} "
              f"ESS_T={r['ess_T']:.0f} errT={r['err_mean_T']:.3g}", flush=True)
    print(f"whole-sweep sampling time: {rows[0]['time']:.1f}s "
          f"({len(rows)} cells x {args.n_chains} chains, one program)")

    if args.out:
        import csv
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"saved grid results to {args.out}")
    if args.figures_dir:
        from .figures import rare_event_heatmaps
        rare_event_heatmaps(rows, args.figures_dir)
        print(f"wrote heatmaps to {args.figures_dir}")
    return rows


if __name__ == "__main__":
    main()
