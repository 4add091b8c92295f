"""aux_ssm_tpu — auxiliary MCMC / particle-Gibbs samplers for generalised
Feynman–Kac state-space models, in JAX/XLA.

A from-scratch framework with the capability surface of the reference
`aux_samplers` package (Corenflos & Särkkä, arXiv:2303.00301; reference
layout: aux_samplers/__init__.py:1-4), with:

- mask-based (fully finite) missing-data handling — no infs, no `lax.cond`
  branches inside scans, safe under f32;
- parallel-in-time Kalman filtering/sampling as associative scans;
- first-class device-mesh sharding (chains / particles / batch axes) with
  collective resampling and adaptation reductions;
- one typed config system, `.npz` checkpointing, online statistics.

Public surface mirrors the reference's top level (aux_samplers/__init__.py:1-4):
`SamplerState`, linearisation rules (`extended`, `cubature`, `gauss_hermite`),
`mvn`, and `delta_adaptation`.
"""

from .kernels.base import SamplerState
from .kernels.adaptation import delta_adaptation
from .ops import mvn
from .ops.linearise import extended, cubature, gauss_hermite

__version__ = "0.1.0"

__all__ = [
    "SamplerState",
    "delta_adaptation",
    "mvn",
    "extended",
    "cubature",
    "gauss_hermite",
]
