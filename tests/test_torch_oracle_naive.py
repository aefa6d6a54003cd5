"""The port's naive rough-glass furnace image against the reference
oracle's (`glass_naive`, tests/goldens/oracle_images.npz), at 512 spp.
Scene, bar and sample count as tests/test_torch_oracle.py says; a file of
its own, since 512 spp take ~45 s of render on the CPU."""

import torch

from test_torch_oracle import furnace_material_parity, oracle  # noqa: F401 (fixture)

torch.set_num_threads(2)


def test_glass_naive_image_parity(oracle):
    furnace_material_parity(oracle, "glass_naive")
