"""The port's architecture configs against ``repro.configs`` field for field,
and qwen3 (the one family member with ``qk_norm``) through the port's
transformer against the JAX package on the CPU at REDUCED size.

Every field but ``scan_unroll`` (a knob of JAX's layer scan that the port
has no use for) is equal, ``dtype`` mapped (``jnp.bfloat16`` ->
``torch.bfloat16``); ``param_count`` and ``active_param_count`` are equal
integers.  The models to the tolerances of ``torch_lm_parity``.
"""
import dataclasses

import jax.numpy as jnp
import pytest
import torch
from torch_parity import one_intra_op_thread  # noqa: F401

from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from torch_lm_parity import (check_bf16_loss, check_decode, check_forward_and_loss, check_init,
                             check_prefill, check_round_trip_bf16, check_train_step)

DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
QWEN3 = ["qwen3-14b", "qwen3-32b"]


def test_archs_are_the_reference_archs():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.model_archs() == jconfigs.model_archs()
    assert len(tconfigs.model_archs()) == 10


@pytest.mark.parametrize("arch", jconfigs.model_archs())
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_field_for_field(arch, reduced):
    want, got = jconfigs.get(arch, reduced), tconfigs.get(arch, reduced)
    want_fields = {f.name for f in dataclasses.fields(want)} - {"scan_unroll"}
    assert {f.name for f in dataclasses.fields(got)} == want_fields
    for name in sorted(want_fields):
        w, g = getattr(want, name), getattr(got, name)
        if name == "dtype":
            assert DTYPE[w] == g
        else:
            assert g == w and type(g) is type(w), name
    assert got.moe_hidden == want.moe_hidden
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("arch,total,active", [
    ("qwen2-moe-a2.7b", 1.4316e10, 2.6860e9), ("grok-1-314b", 3.1649e11, 8.4558e10),
    ("mamba2-2.7b", 2.8308e9, None), ("whisper-medium", 9.5918e8, None),
    ("qwen3-14b", 1.4768e10, None), ("qwen3-32b", 3.2762e10, None),
])
def test_published_param_counts(arch, total, active):
    cfg = tconfigs.get(arch)
    assert cfg.param_count() == pytest.approx(total, rel=1e-4)
    assert cfg.active_param_count() == pytest.approx(active or total, rel=1e-4)


@pytest.mark.parametrize("reduced", [False, True])
def test_paper_ae_is_the_reference_aeconfig(reduced):
    want, got = jconfigs.get("paper_ae", reduced), tconfigs.get("paper-ae", reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__name__ == "AEConfig"


def test_every_published_name_resolves():
    """The reference's alias table is the port's replace rule."""
    for name, arch in jconfigs._ALIASES.items():
        assert tconfigs.canonical(name) == arch == jconfigs.canonical(name)
        assert tconfigs.get(name).name == jconfigs.get(name).name


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get("gpt-5")


# --- qwen3: qk_norm through the port's transformer --------------------------------------

@pytest.mark.parametrize("arch", QWEN3)
def test_qwen3_forward_and_loss_match_reference(arch):
    check_forward_and_loss(arch)


@pytest.mark.parametrize("arch", QWEN3)
def test_qwen3_bf16_loss_matches_reference(arch):
    check_bf16_loss(arch)


@pytest.mark.parametrize("arch", QWEN3)
def test_qwen3_train_step_matches_reference(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", QWEN3)
def test_qwen3_prefill_step_is_the_last_row_of_forward(arch):
    check_prefill(arch)


@pytest.mark.parametrize("arch", QWEN3)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qwen3_decode_teacher_forced_matches_reference(arch, dtype):
    """48 steps, batch 2, with the q/k norms carried from the reference at
    nonzero values (``init`` gives zeros, which a ``1 + scale`` norm makes
    a plain RMSNorm)."""
    check_decode(arch, dtype, 48)


@pytest.mark.parametrize("arch", QWEN3)
def test_qwen3_init_and_round_trip(arch):
    check_init(arch, "bf16")
    check_round_trip_bf16(arch)
