"""The controls (the reference in the precision below the one the config
states, put in the program's place) read above what the program reads:
on the CPU for the fp8 decode and UNet, on the card for all three,
through ``calibrate.readings`` at a tiny size."""
import pytest

from benchmark import calibrate
from benchmark.harness import cells
from benchmark.tests import tiny


@pytest.mark.parametrize('name', ['cars_uncond.view',
                                  'cars_uncond_bf16.sample'])
def test_fp8_controls_move_the_numbers(name):
    ctx = cells.Context(tiny.tiny_cell(name), 5, 0, 0, tiny.CPU)
    control = calibrate.readings(ctx)['control']
    assert max(control.values()) > 0, control


@pytest.mark.gpu
@pytest.mark.parametrize('name', ['cars_uncond.train', 'cars_uncond.view',
                                  'cars_uncond_bf16.sample'])
def test_controls_exceed_the_limits_on_the_card(name, cuda_device):
    cell = tiny.tiny_cell(name)
    ctx = cells.Context(cell, 5, 0, 0, cuda_device)
    control = calibrate.readings(ctx)['control']
    assert any(v > cell['limits'][k] for k, v in control.items()), control
