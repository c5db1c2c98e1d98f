"""The port of the march probe (``tools/march_scalar_probe.py``) vs the JAX
package on the CPU: the byte table, and the per-row counts of occupied
samples against the probe's own oracle on its shapes and draws.  The kernel
(``march_popcount``) is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import numpy as np
import jax.numpy as jnp
import torch

from ssdnerf_tpu.ops.morton import packbits as jpackbits
from ssdnerf_tpu.ops.pallas.march import occupancy_table as joccupancy_table
from ssdnerf_torch.ops.kernels import march as tmarch
from ssdnerf_torch.ops.morton import occupancy_table, packbits
from ssdnerf_torch.tools import march_scalar_probe as probe

torch.set_num_threads(2)


def test_occupancy_table_matches_jax():
    """The port's table is JAX's int8 table + 128, as uint8, on a seeded
    10%-occupancy bitfield of 2 scenes."""
    rng = np.random.RandomState(3)
    occ = (rng.rand(2, 64 ** 3) < 0.1).astype(np.float32)
    want = np.asarray(joccupancy_table(jpackbits(jnp.asarray(occ), 0.5), 64))
    got = occupancy_table(packbits(torch.from_numpy(occ), 0.5), 64)
    assert got.dtype == torch.uint8 and got.shape == (2, 128, 256)
    np.testing.assert_array_equal(
        got.numpy(), (want.astype(np.int32) + 128).astype(np.uint8))


def test_occupied_counts_match_probe_oracle():
    """The JAX tool's shapes and draws (2 scenes, 2048 rays x 256 steps,
    rows of 1024): the probe's inputs are the same draws, and
    ``occupied_counts`` equals the tool's numpy oracle
    (``tools/march_scalar_probe.py:124-134``, transcribed: ``scalar_march``
    takes no interpret flag) on the JAX package's table."""
    S, R, T, SUB = probe.S, probe.R, probe.T, probe.SUB
    assert (S, R, T, SUB) == (2, 2048, 256, 1024)
    rng = np.random.RandomState(0)
    occ = jnp.asarray(rng.rand(S, 64 ** 3) < 0.10, jnp.float32)
    table = joccupancy_table(jpackbits(occ, 0.5), 64)
    ji = rng.randint(0, 2 ** 17, (S, R, T)).astype(np.int32)
    ji[rng.rand(*ji.shape) < 0.1] = -1
    jr = ji.reshape(-1, SUB)
    tab_np = np.asarray(table).astype(np.int32) + 128
    rows = jr.shape[0]
    s_of_row = np.arange(rows) // (R * T // SUB)
    live = jr >= 0
    jc = np.where(live, jr, 0)
    byte = tab_np[s_of_row[:, None], jc >> 11, (jc >> 3) & 255]
    ref = np.where(live, (byte >> (jc & 7)) & 1, 0).sum(-1)

    inp = probe.make_inputs()
    np.testing.assert_array_equal(inp['ji'].numpy(), jr)
    np.testing.assert_array_equal(inp['table'].numpy().astype(np.int32),
                                  tab_np)
    got = tmarch.occupied_counts(inp['ji'], inp['table'])
    assert got.dtype == torch.int32 and got.shape == (rows,)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))


def test_probe_tool_runs_on_cpu(monkeypatch):
    """The tool's path with ``device='cpu'`` (plain versions): counts
    checked, both timings and their ratio reported (one timed call each)."""
    monkeypatch.setattr(probe, 'REPS', 1)
    res = probe.run('cpu')
    assert res['device'] == 'cpu' and res['samples'] == 2 * 2048 * 256
    assert res['popcount_ms'] > 0 and res['march_ms'] > 0
    assert res['ratio'] == res['popcount_ms'] / res['march_ms']
