#!/bin/bash
# Parameter-scan runner (reference: jonas_test_analyses/runner_tree.sh):
# fixed seed 1769, axion-mass x coupling grid.
seed=1769
for m in 1e-5 2e-5 4e-5; do
  for g in 1e-14 1e-13 1e-12 1e-11 1e-10 1e-9 1e-8; do
    python -m adiabatic_raytracer --Nts 200 --seed $seed --saveMode 1 \
      --MassA $m --Axg $g --ftag "scan_${m}_${g}"
  done
done
