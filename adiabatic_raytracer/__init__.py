"""Adiabatic RayTracer — a JAX (XLA) axion–photon ray-tracing framework.

A batched re-implementation, run on NVIDIA GPUs (and on the CPU for tests),
with the capabilities of the Julia reference SamWitte/Adiabatic_RayTracer
(see SURVEY.md):

* Goldreich–Julian magnetosphere fields + plasma frequency  (models/magnetosphere.py)
* Schwarzschild metric incl. interior continuation          (models/metric.py)
* Photon/axion dispersion relations & Hamiltonians          (ops/dispersion.py)
* Batched adaptive RK integrator with event detection       (ops/integrator.py)
* Conversion physics (Landau–Zener probability, jacobians)  (ops/conversion.py)
* Conversion-surface Monte-Carlo sampler                    (ops/sampler.py)
* Weighted branching-tree MC engine                         (ops/tree.py)
* Driver / CLI / file formats matching the reference        (driver.py, cli.py)
* Mesh sharding + on-device reductions                      (parallel/)

Design stance: instead of the reference's one-ray-at-a-time, callback-driven
architecture, everything here operates on fixed-shape batches of rays advanced
in lockstep by a `lax.while_loop` adaptive stepper, with events detected by
sign-change + bisection on dense output, and the Monte-Carlo tree realized as
a bounded node pool updated with masked writes.
"""

__version__ = "0.1.0"

from adiabatic_raytracer.config import Scene, NumericsConfig, TreeConfig  # noqa: F401
