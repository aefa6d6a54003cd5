"""The port's thin-glass furnace image against the reference oracle's
(`thinglass_mis`, tests/goldens/oracle_images.npz): the sphere as thin
rough glass (the flip trick, parametric.cpp:527-536), MIS at 64 spp.
Scene, bar and sample count as tests/test_torch_oracle.py says; a file of
its own, since its transparent shadows take ~40 s of render on the CPU."""

import torch

from test_torch_oracle import furnace_material_parity, oracle  # noqa: F401 (fixture)

torch.set_num_threads(2)


def test_thinglass_image_parity(oracle):
    furnace_material_parity(oracle, "thinglass_mis")
