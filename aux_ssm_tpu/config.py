"""Typed configuration system — one structured config replacing the
reference's per-script argparse duplication (SURVEY §5 "Config / flag
system"; axes from `examples/*/experiment.py:16-57`).

Dataclasses compose: ExperimentConfig = precision/backend + model sizes +
MCMC schedule (RunConfig, see experiments.runner) + sampler style + mesh.
`apply_backend()` applies the global JAX settings; `from_args()` builds a
config from CLI-style overrides so experiment scripts stay one-liners.
"""
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

from .experiments.runner import RunConfig

# The persistent compile cache's default home: a fixed directory inside the
# checkout (listed in .gitignore). The path is part of each entry's key, so
# it never depends on a temporary name, a process id or the time.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir():
    """Where compiled programs persist: `JAX_COMPILATION_CACHE_DIR` when it
    is set (JAX reads it itself), else `DEFAULT_COMPILE_CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
        DEFAULT_COMPILE_CACHE_DIR


def enable_compile_cache():
    """Turn on JAX's persistent compile cache. The one place the cache is
    configured: every entry point (experiment drivers through
    `BackendConfig.apply`, `bench.py`, `chip_smoke.py`) calls this."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          DEFAULT_COMPILE_CACHE_DIR)
    return compile_cache_dir()


@dataclass(frozen=True)
class BackendConfig:
    """Global JAX/XLA settings (reference flags: --precision, --gpu,
    --debug, --debug-nans)."""
    precision: str = "single"          # 'single' | 'double'
    platform: Optional[str] = None     # None = default; 'cpu' | 'gpu'
    debug: bool = False                # disable jit
    debug_nans: bool = False
    # On the GPU, f32 matmuls run in TF32 by default (about three decimal
    # digits). That rounding enters the filter algebra and the proposal
    # log-densities, and it does not cancel in the MH ratio. 'highest'
    # keeps f32 products in f32.
    matmul_precision: str = "highest"  # 'default' | 'high' | 'highest'

    def apply(self):
        import jax
        enable_compile_cache()
        jax.config.update("jax_enable_x64", self.precision == "double")
        if self.matmul_precision != "default":
            jax.config.update("jax_default_matmul_precision",
                              self.matmul_precision)
        if self.platform:
            jax.config.update("jax_platforms", self.platform)
        if self.debug:
            jax.config.update("jax_disable_jit", True)
        if self.debug_nans:
            jax.config.update("jax_debug_nans", True)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: axis names and sizes (-1 = inferred)."""
    axis_names: Tuple[str, ...] = ("chains",)
    axis_sizes: Optional[Tuple[int, ...]] = None

    def build(self, devices=None):
        from .parallel.mesh import make_mesh
        return make_mesh(self.axis_sizes, devices, self.axis_names)


@dataclass(frozen=True)
class SamplerConfig:
    """Sampler selection (reference --style/--gradient/--backward/--N)."""
    style: str = "kalman-1"   # kalman-1 | kalman-2 | csmc | csmc-guided | pgas
    parallel: bool = True     # parallel-in-time execution
    gradient: bool = False
    backward: bool = True
    ancestor_sampling: bool = False
    n_particles: int = 25
    resampling: str = "multinomial"


@dataclass(frozen=True)
class ExperimentConfig:
    backend: BackendConfig = field(default_factory=BackendConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    run: RunConfig = field(default_factory=RunConfig)
    seed: int = 42
    n_chains: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0          # 0 = only final


def _set(cfg, path, value):
    """Immutable nested update: _set(cfg, 'run.n_samples', 100)."""
    head, _, rest = path.partition(".")
    if rest:
        return dataclasses.replace(cfg, **{head: _set(getattr(cfg, head), rest, value)})
    current = getattr(cfg, head)
    if current is not None and not isinstance(value, type(current)):
        value = type(current)(value)
    return dataclasses.replace(cfg, **{head: value})


def from_args(base: Optional[ExperimentConfig] = None, **overrides) -> ExperimentConfig:
    """Build a config from dotted-path overrides, e.g.
    from_args(**{"run.n_samples": 10_000, "sampler.style": "csmc"})."""
    cfg = base or ExperimentConfig()
    for path, value in overrides.items():
        cfg = _set(cfg, path, value)
    return cfg
