from adiabatic_raytracer.models import metric, magnetosphere  # noqa: F401
