"""The port's config registry against the reference's.

``repro_torch.configs`` is a copy of ``repro.configs`` (pure Python on
both sides, no JAX compile): every registered arch's ``get_config`` and
``smoke_config`` equal the reference's field by field
(``dataclasses.asdict``), and so do the derived answers the LM stack and
the benchmarks read (``param_count`` in both modes, ``padded_vocab``,
``layer_kinds``, ``shape_applicable`` over ``SHAPES``).
"""
import dataclasses

import pytest

from repro.configs import base as ref
from repro_torch.configs import base as port

ARCHS = ref.list_archs()


def test_registry_lists_the_reference_archs():
    assert port.list_archs() == ARCHS
    assert len(ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in port.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        port.get_config("no-such-arch")


def _answers(mod, cfg):
    return {"asdict": dataclasses.asdict(cfg),
            "param_count": cfg.param_count(),
            "param_count_active": cfg.param_count(active_only=True),
            "padded_vocab": cfg.padded_vocab(),
            "padded_vocab_4096": cfg.padded_vocab(4096),
            "head_dim": cfg.resolved_head_dim,
            "layer_kinds": cfg.layer_kinds(),
            "attention_free": cfg.is_attention_free,
            "long_context": cfg.supports_long_context,
            "applicable": {name: mod.shape_applicable(cfg, shape)
                           for name, shape in mod.SHAPES.items()}}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert _answers(port, port.get_config(arch)) == \
        _answers(ref, ref.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_matches_reference(arch):
    got = port.smoke_config(port.get_config(arch))
    want = ref.smoke_config(ref.get_config(arch))
    assert _answers(port, got) == _answers(ref, want)
    assert got.param_dtype == got.compute_dtype == "float32"
