"""Packaging: the framework is pip-installable (editable) with a console
entry point (pyproject.toml)."""

import importlib.metadata

import pytest


def _dist():
    try:
        return importlib.metadata.distribution("adiabatic-raytracer")
    except importlib.metadata.PackageNotFoundError:
        pytest.skip("package not installed — run `pip install -e .`")


def test_installed_metadata():
    dist = _dist()
    import adiabatic_raytracer

    assert dist.version == adiabatic_raytracer.__version__


def test_console_script_resolves_to_cli_main():
    dist = _dist()
    eps = [ep for ep in dist.entry_points
           if ep.name == "adiabatic-raytracer"]
    assert eps, "console script missing"
    fn = eps[0].load()
    from adiabatic_raytracer.cli import main

    assert fn is main
