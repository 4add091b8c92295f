#!/usr/bin/env bash
# Stochastic-volatility experiment schedule — the paper grid encoded by
# reference `examples/stochastic_volatility/experiment.sh:1-10` (styles x
# gradient at T=250, D=30, N=25, target alpha 0.5), run on whatever backend
# JAX resolves (the GPU; pass --platform cpu to force CPU). One invocation
# per style writes the standard .npz schema (samples moments, EJSD, delta,
# sampling_time) consumed by `experiments.figures sv_style_comparison`.
set -euo pipefail
OUT=${1:-results/sv}
T=${T:-250}
D=${D:-30}
mkdir -p "$OUT"
common=(--T "$T" --D "$D" --parallel --target-alpha 0.5
        --delta-init 1e-8 --lr 0.1
        --n-samples 10000 --burnin 2500 --seed 42)
python -m aux_ssm_tpu.experiments.sv "${common[@]}" --style kalman-1 \
  --out "$OUT/kalman1.npz"
python -m aux_ssm_tpu.experiments.sv "${common[@]}" --style kalman-2 \
  --out "$OUT/kalman2.npz"
for grad in --no-gradient --gradient; do
  python -m aux_ssm_tpu.experiments.sv "${common[@]}" --style csmc \
    --N 25 "$grad" --out "$OUT/csmc${grad/--/_}.npz"
  python -m aux_ssm_tpu.experiments.sv "${common[@]}" --style csmc-guided \
    --N 25 "$grad" --out "$OUT/csmc_guided${grad/--/_}.npz"
done
