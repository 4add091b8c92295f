"""cSMC with the particle axis sharded over a device mesh.

New-to-the-build component (the reference is single-client; SURVEY §2.4 P4):
the forward sweep runs with N particles sharded over the `particles` mesh
axis. All per-particle model math (proposal sampling, potentials) stays
chip-local; the two global operations — weight normalisation and the
conditional-resampling gather — are expressed as ordinary jnp ops on arrays
carrying a NamedSharding constraint, which GSPMD lowers to psum /
all-gather+dynamic-slice. The categorical indices are computed from
replicated normalised weights, so the draw follows the single-device
kernel's key stream.

The backward passes run sharded too (`shard_map` over the particle axis):
the stored (T, N, d) trajectory array never materialises on one device —
per step only the (N,) weight row is all-gathered (so the categorical draw
runs on the full-order weight vector, as on one device) and the one chosen
particle row travels by masked psum. Peak per-device trajectory footprint
is T·N·d/S.
"""
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from .csmc import (forward_pass, backward_scanning_pass,
                   backward_sampling_pass, factor_backward_pass,
                   _use_factor_backward)
from .base import f32_matmuls
from .csmc_base import CSMCState, Distribution, UnivariatePotential, Dynamics, Potential
from ..ops import resampling as resampling_mod
from ..ops.logspace import normalize
from ..parallel.mesh import PARTICLES


def get_sharded_kernel(M0: Distribution, G0: UnivariatePotential, Mt: Dynamics,
                       Gt: Potential, N: int, mesh, backward: bool = False,
                       Pt: Dynamics = None, resampling="multinomial"):
    """Like `csmc.get_kernel` but with the particle axis sharded over
    `mesh`'s `particles` axis. N must be divisible by the axis size."""
    n_shards = mesh.shape[PARTICLES]
    if N % n_shards:
        raise ValueError(f"N={N} not divisible by particles axis size {n_shards}")
    if backward and Pt is None:
        Pt = Mt
    if backward and not hasattr(Pt, "logpdf"):
        raise ValueError("backward=True requires `Pt` to implement logpdf.")
    resample = resampling_mod.get(resampling) if isinstance(resampling, str) else resampling

    particle_sharding = NamedSharding(mesh, P(PARTICLES))

    if n_shards == 1:
        # A 1-device particles mesh is plain single-device execution;
        # passing no constraint lets `forward_pass` take its specialised
        # sweeps (which are disabled under sharding constraints).
        constrain = None
    else:
        def constrain(z):
            return jax.lax.with_sharding_constraint(z, particle_sharding)

    @f32_matmuls
    def kernel(key, state):
        key_fwd, key_bwd = jax.random.split(key)
        w_T, xs, log_ws, ancestors = forward_pass(
            key_fwd, state.x, M0, G0, Mt, Gt, N, resample, constrain=constrain
        )
        if n_shards == 1:
            if backward and _use_factor_backward(Pt):
                # Same dispatch as csmc.get_kernel.
                x, picked = factor_backward_pass(key_bwd, Pt, w_T, xs, log_ws)
            elif backward:
                x, picked = backward_sampling_pass(key_bwd, Pt, w_T, xs,
                                                   log_ws)
            else:
                x, picked = backward_scanning_pass(key_bwd, w_T, xs, ancestors)
        elif backward:
            x, picked = sharded_backward_sampling_pass(
                mesh, key_bwd, Pt, w_T, xs, log_ws)
        else:
            x, picked = sharded_backward_scanning_pass(
                mesh, key_bwd, w_T, xs, ancestors)
        return CSMCState(x=x, updated=picked != 0)

    def init(x_star):
        T = x_star.shape[0]
        return CSMCState(x=x_star, updated=jnp.zeros((T,), dtype=bool))

    return init, kernel


def _fetch_row(axis, shard, local, pos_global):
    """Row `pos_global` of an array whose leading axis is sharded over
    `axis`: the owning shard contributes it, everyone receives it by psum."""
    local_n = local.shape[0]
    owner, pos = pos_global // local_n, pos_global % local_n
    row = jnp.where(shard == owner, local[pos], jnp.zeros_like(local[0]))
    return jax.lax.psum(row, axis)


def sharded_backward_sampling_pass(mesh, key, Pt: Dynamics, w_T, xs, log_ws,
                                   axis=PARTICLES):
    """Whiteley backward sampling with the particle axis of `xs`/`log_ws`
    sharded over `axis`. Per step, the (N,) smoothing-weight row is
    all-gathered (bytes on the wire) so the categorical draw runs on the
    exact full-order weight vector — the single-device
    `backward_sampling_pass`'s draw for the same key — while the (T, N, d)
    trajectory block stays sharded; the chosen row travels by masked psum."""
    T = log_ws.shape[0]
    us = jax.random.uniform(key, (T,), dtype=log_ws.dtype)

    def body(w_T_, us_, xs_l, log_ws_l, params):
        shard = jax.lax.axis_index(axis)
        B_T = resampling_mod.categorical_from_uniform(us_[-1], w_T_)
        x_T = _fetch_row(axis, shard, xs_l[-1], B_T)

        def step(x_next, inp):
            u_t, xs_t_l, log_w_t_l, params_t = inp
            lw_l = Pt.logpdf(x_next, xs_t_l, params_t) + log_w_t_l
            lw = jax.lax.all_gather(lw_l, axis, tiled=True)
            B_t = resampling_mod.categorical_from_uniform(u_t, normalize(lw))
            x_t = _fetch_row(axis, shard, xs_t_l, B_t)
            return x_t, (x_t, B_t)

        inputs = (us_[:-1], xs_l[:-1], log_ws_l[:-1], params)
        _, (traj, picked) = jax.lax.scan(step, x_T, inputs, reverse=True)
        traj = jnp.concatenate([traj, x_T[None]], axis=0)
        picked = jnp.concatenate([picked, B_T[None]], axis=0)
        return traj, picked

    # check_vma=False: every shard provably computes identical outputs (the
    # draw runs on the all-gathered weight row; rows arrive by psum), but the
    # replication can't be statically inferred through the scan.
    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(None, axis), P(None, axis), P()),
        out_specs=(P(), P()), check_vma=False,
    )(w_T, us, xs, log_ws, Pt.params)


def sharded_backward_scanning_pass(mesh, key, w_T, xs, ancestors,
                                   axis=PARTICLES):
    """Genealogy trace with `xs` (T, N, d) and `ancestors` (T-1, N) sharded
    over `axis`: a sequential O(T) pointer chase where each lookup moves one
    int / one row by masked psum. Integer arithmetic — picks are bitwise
    identical to the single-device `backward_scanning_pass`."""

    def body(key_, w_T_, xs_l, anc_l):
        shard = jax.lax.axis_index(axis)
        B_T = jax.random.choice(key_, w_T_.shape[0], p=w_T_).astype(jnp.int32)
        x_T = _fetch_row(axis, shard, xs_l[-1], B_T)

        def step(B_next, inp):
            anc_t_l, xs_t_l = inp
            B_t = _fetch_row(axis, shard, anc_t_l.astype(jnp.int32), B_next)
            x_t = _fetch_row(axis, shard, xs_t_l, B_t)
            return B_t, (x_t, B_t)

        _, (traj, picked) = jax.lax.scan(step, B_T, (anc_l, xs_l[:-1]),
                                         reverse=True)
        traj = jnp.concatenate([traj, x_T[None]], axis=0)
        picked = jnp.concatenate([picked, B_T[None]], axis=0)
        return traj, picked

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(None, axis), P(None, axis)),
        out_specs=(P(), P()),
    )(key, w_T, xs, ancestors)
