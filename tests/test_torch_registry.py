"""The port's model-family registry (``umx_tpu_torch.models.registry``)
against ``umx_tpu.models.registry``: the JAX case, and each family's
engine config equal to the JAX package's on the fields both configs have."""

import dataclasses

import pytest

from umx_tpu.models import registry as jreg
from umx_tpu_torch.models.registry import REGISTRY, family_for_hidden_size, get


def test_registry_families():
    assert get("umxl").hidden_size == 1024
    assert get("umxhq").hidden_size == 512
    assert family_for_hidden_size(1024).name == "umxl"
    assert family_for_hidden_size(512).name == "umxhq"
    assert family_for_hidden_size(64).hidden_size == 64  # custom passthrough
    with pytest.raises(KeyError):
        get("nope")
    for fam in REGISTRY.values():
        cfg = fam.engine_config()
        assert cfg.model.hidden_size == fam.hidden_size


def _shared_fields(ours, theirs, path=""):
    """(path, ours, theirs) for every leaf field that both dataclasses have."""
    out = []
    names = {f.name for f in dataclasses.fields(theirs)}
    for f in dataclasses.fields(ours):
        if f.name not in names:
            continue
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            out += _shared_fields(a, b, f"{path}{f.name}.")
        else:
            out.append((path + f.name, a, b))
    return out


@pytest.mark.parametrize("name", ["umxl", "umxhq"])
def test_families_and_engine_configs_equal_jax(name):
    ours, theirs = get(name), jreg.get(name)
    assert (ours.name, ours.hidden_size, ours.description) == (
        theirs.name, theirs.hidden_size, theirs.description)
    for overrides in ({}, {"shifts": 0, "use_wiener": False}):
        shared = _shared_fields(ours.engine_config(**overrides),
                                theirs.engine_config(**overrides))
        assert len(shared) >= 20  # every field the port has is a JAX field
        for path, a, b in shared:
            assert a == b, (path, a, b)
    assert sorted(REGISTRY) == sorted(jreg.REGISTRY)
    for h in (96, 512, 1024):
        a, b = family_for_hidden_size(h), jreg.family_for_hidden_size(h)
        assert (a.name, a.hidden_size, a.description) == (b.name, b.hidden_size, b.description)
