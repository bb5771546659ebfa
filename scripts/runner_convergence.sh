#!/bin/bash
# Convergence scan (reference: jonas_test_analyses/runner_convergence.sh):
# fixed seed, probCutoff sweep, then coupling sweep.
seed=1769
for prob in 1e-10 5e-11 1e-11; do
  python -m adiabatic_raytracer --Nts 200 --seed $seed --saveMode 2 \
    --probCutoff $prob --ftag "convergence_$prob"
done
for g in 1e-14 3.16e-14 1e-13 3.16e-13 1e-12 3.16e-12 1e-11 3.16e-11 1e-10 3.16e-10 1e-9 3.16e-9; do
  python -m adiabatic_raytracer --Nts 200 --seed $seed --saveMode 2 \
    --Axg $g --ftag "coupling_$g"
done
