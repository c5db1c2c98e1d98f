"""Runs with the timed path broken underneath come out not correct: each
fault the cells can have, planted in the program, through a whole run on
the CPU at a tiny size (the run's look for a chip skipped)."""
import pytest

from benchmark import faults
from benchmark.tests import tiny
from benchmark.tests.test_bench_rehearsal import run_line


def _program(kind):
    if kind == 'view':
        from ssdnerf_torch.core.gui import SSDNeRFViewer
        return SSDNeRFViewer
    from ssdnerf_torch.models.autodecoders import DiffusionNeRF
    return DiffusionNeRF


FAULTS = {
    'state_unchanged': ('cars_uncond.train', faults.unchanged),
    'half_batch': ('cars_uncond.train', faults.half_batch),
    'frame_altered': ('cars_uncond.view', faults.altered_render_view),
    'scenes_swapped': ('cars_uncond_bf16.sample', faults.altered_val_uncond),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_is_not_correct(fault):
    name, plant = FAULTS[fault]
    cell = tiny.tiny_cell(name)
    with plant(_program(cell['entry'])):
        line = run_line(cell)
    assert line['correct'] is False, line['checks']
