#!/bin/bash
#SBATCH --job-name=art
#SBATCH --ntasks=10
#SBATCH --gpus-per-task=1
#SBATCH --mem-per-cpu=8G
#SBATCH --time=100:00:00
# Cluster runner (reference: src/runner_GR_tasks.sh) — ten shard tasks plus
# a final combine task.  Each task gets a card of its own (--gpus-per-task=1:
# SLURM binds it through CUDA_VISIBLE_DEVICES), so no two JAX processes
# share a card.  On a multi-GPU node a single process with --mesh over the
# node's cards does the same work without the file merge.
declare -i trajs=900
for i in $(seq 0 9); do
  srun --ntasks=1 --gpus-per-task=1 --exclusive \
    python -m adiabatic_raytracer --MassA 1e-5 --B0 1e14 --ThetaM 0.2 \
      --Nts $trajs --ftag "gr_$i" &> "gr_$i.log" &
done
wait
srun --ntasks=1 --exclusive \
  python -m adiabatic_raytracer --run_RT 0 --run_Combine 1 --side_runs 10 \
    --MassA 1e-5 --B0 1e14 --ThetaM 0.2 --Nts $trajs --ftag "gr_"
