#!/bin/bash
# Production runner (reference: src/runner_example.sh, which forks six
# 1,000-event processes on one host and merges their files).  Here one
# process runs all 6,000 events and shards each batch over the host's GPUs
# with --mesh.  Never start two JAX processes on one card: each reserves
# most of the card's memory when it starts.
ngpu=$(nvidia-smi -L 2>/dev/null | wc -l)
time python -m adiabatic_raytracer --MassA 1e-5 --B0 1e14 --ThetaM 0.2 \
    --Nts 6001 --probCutoff 1e-10 --numCutoff 50 --MCNodes 10 \
    --maxNodes 100 --mesh "$ngpu" --ftag example &> example.log
