"""chip_smoke.py: every phase at a tiny size on the CPU, and the refusal to
run (no result line, non-zero exit) where JAX finds no GPU."""
import pytest

import jax

import chip_smoke


@pytest.mark.parametrize("argv", [[], ["--cards", "4"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "phase" not in out


PHASES = {
    "stream": lambda: chip_smoke.phase_stream(32, 48, n=2),
    "served": lambda: chip_smoke.phase_served(32, 48, n=3),
    "all_stages": lambda: chip_smoke.phase_all_stages(32, 48),
    "variants": lambda: chip_smoke.phase_variants(40, 64, vga=(24, 32)),
    "batch_sweep": lambda: chip_smoke.phase_batch_sweep(32, 48, b=2),
    "mega": lambda: chip_smoke.phase_mega(((64, 96), (72, 128))),
    "sharded": lambda: chip_smoke.phase_sharded(4, (32, 48), (64, 96)),
}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_passes_at_tiny_size(name):
    res = PHASES[name]()
    assert isinstance(res, dict) and res


def test_single_card_phases_are_the_documented_ones():
    assert [n for n, _ in chip_smoke.SINGLE_CARD_PHASES] == [
        "stream", "served", "all_stages", "variants", "batch_sweep", "mega"]


def test_check_raises_on_mismatch():
    import numpy as np

    with pytest.raises(chip_smoke.SmokeFailure, match="1 pixels differ"):
        chip_smoke.assert_exact(np.array([0, 255]), np.array([0, 0]), "x")
