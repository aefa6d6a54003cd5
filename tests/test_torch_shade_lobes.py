"""B5's lane keys and its wrapper's argument structs, on the CPU.

The kernel orders each tile's lanes by picked lobe before it shades them.
`kernels/shade.py` `lobe_keys` gives each lane that key from the twin's
own pick (`shade_math.lobe_pick`, shared with `bsdf_sample_c`), and
`mixed_warps` counts the warps that hold lanes of more than one key in
lane order and after the kernel's grouping (chip_smoke.py reports both
per B5 case). Here the keys are held against the sample the twin picks
and against the JAX package's `bsdf_sample_c` on the same seeded lanes,
and `mixed_warps` against counts made by hand. The keys are exact
(integers from comparisons of the same float values); the JAX check
compares the picked sample's flags exactly and its pdf at rtol 1e-5 (the
lobe pdfs differ by far more where two lobes could be confused)."""

import numpy as np
import pytest
import torch

from yart_tpu.kernels import shade_math as JSM
from yart_tpu.ops import lut as JL
from yart_tpu_torch.kernels import shade as TK
from yart_tpu_torch.kernels import shade_math as TSM
from yart_tpu_torch.ops import lut as TL

from test_torch_shade import jax_inp, make_lanes, port_inp

N = 1024
GATE_SETS = [(True, True, True, True), (True, True, False, False), (False, True, False, True),
             (False, False, True, False), (False, False, False, False)]
KEY = {name: i for i, name in enumerate(TK.LOBES)}


@pytest.fixture(scope="module")
def lanes():
    return make_lanes(N, 11, dead_first_block=False)


@pytest.mark.parametrize("gates", GATE_SETS, ids=lambda g: "".join("MDCA"[i] for i in range(4) if g[i]) or "none")
def test_lobe_keys_name_the_twins_sample(lanes, gates):
    """Where a lane's key is a lobe, the twin's picked sample is that
    lobe's own sample (flags and pdf, bit for bit); dead lanes are those
    neither active nor found."""
    inp = port_inp(lanes)
    tables = TL.load_tables("cpu")
    keys = TK.lobe_keys(inp, gates, tables)
    c = TSM.components(inp)
    cand = TSM.candidates(c, gates)
    fet = TSM.run_fetches(tables, cand["coords"])
    picked = TSM.bsdf_sample_c(c, cand, fet, gates)
    own = {"glossy": TSM._sample_glossy_c(c, cand, fet)}
    if gates[0]:
        own["metal"] = TSM._sample_metallic_c(c, cand, fet)
    if gates[1]:
        own["dielectric"] = TSM._sample_dielectric_c(c, cand, fet)
    if gates[2]:
        own["coat"] = TSM._sample_clearcoat_c(c, cand, fet)
    live = inp["active"] | inp["found"]
    assert torch.equal(keys == KEY["dead"], ~live)
    for name, smp in own.items():
        at = (keys == KEY[name]).numpy()
        assert torch.equal(picked["flags"][at], smp["flags"][at]), name
        assert torch.equal(picked["pdf"][at].view(torch.int32), smp["pdf"][at].view(torch.int32)), name
    for name in ("coat", "metal", "dielectric"):
        if name not in own:
            assert not (keys == KEY[name]).any(), name
    assert len(set(keys[live].tolist())) == len(own)  # every gated lobe is picked somewhere


@pytest.mark.parametrize("gates", GATE_SETS[:3], ids=["MDCA", "MD", "DA"])
def test_lobe_keys_name_the_jax_sample(lanes, gates):
    """The JAX package's bsdf_sample_c picks the lobe the key names: its
    sample's flags equal that lobe's JAX sample's, and its pdf agrees."""
    inp = port_inp(lanes)
    keys = TK.lobe_keys(inp, gates, TL.load_tables("cpu")).numpy()
    ji = jax_inp(lanes)
    jtab = JL.load_tables()
    cand = JSM.candidates(ji, gates)
    fet = JSM.run_fetches(jtab, cand["coords"])
    picked = JSM.bsdf_sample_c(ji, cand, fet, gates)
    own = {"glossy": JSM._sample_glossy_c(ji, cand, fet)}
    if gates[0]:
        own["metal"] = JSM._sample_metallic_c(ji, cand, fet)
    if gates[1]:
        own["dielectric"] = JSM._sample_dielectric_c(ji, cand, fet)
    if gates[2]:
        own["coat"] = JSM._sample_clearcoat_c(ji, cand, fet)
    flags, pdf = np.asarray(picked["flags"]), np.asarray(picked["pdf"])
    for name, smp in own.items():
        at = keys == KEY[name]
        assert at.any(), name
        np.testing.assert_array_equal(flags[at], np.asarray(smp["flags"])[at], err_msg=name)
        np.testing.assert_allclose(pdf[at], np.asarray(smp["pdf"])[at], rtol=1e-5, err_msg=name)


def test_lobe_keys_follow_the_materials():
    """Lanes whose materials force the pick (chip_smoke's interleaved
    lobes): clearcoat 1 with uc2 0 picks the coat, metallic 1 the metal,
    transmission 1 the dielectric, none of them glossy; without the coat
    gate the coat lanes fall to glossy."""
    inp = port_inp(make_lanes(400, 3))
    kind = torch.arange(400) % 4
    one, zero = torch.ones(400), torch.zeros(400)
    inp["clearcoat"] = torch.where(kind == 0, one, zero)
    inp["uc2"] = torch.where(kind == 0, zero, inp["uc2"])
    inp["metallic"] = torch.where(kind == 1, one, zero)
    inp["transmission"] = torch.where(kind == 2, one, zero)
    inp["active"] = torch.ones(400, dtype=torch.bool)
    tables = TL.load_tables("cpu")
    assert torch.equal(TK.lobe_keys(inp, (True,) * 4, tables), kind)
    no_coat = TK.lobe_keys(inp, (True, True, False, True), tables)
    assert torch.equal(no_coat, torch.where(kind == 0, KEY["glossy"], kind))


@pytest.mark.parametrize("case", ["interleaved", "one_key", "ragged", "dead_tiles", "boundaries"])
def test_mixed_warps_counts(case):
    """mixed_warps against counts made by hand: per 128-lane tile the
    grouping sorts lanes by key (stable), so a tile of k keys whose runs
    are not whole warps leaves a mixed warp at each run boundary that
    falls inside a warp."""
    if case == "interleaved":  # 4 keys lane by lane: 32 of each a tile
        keys, before, after = torch.arange(1024) % 4, 32, 0
    elif case == "one_key":
        keys, before, after = torch.full((1000,), 2), 0, 0
    elif case == "ragged":  # 200 lanes, keys 0 / 1 alternating: tile 1 sorts to 64 + 64 (whole
        # warps), tile 2 (72 lanes) to 36 + 36: its second warp holds both keys
        keys, before, after = torch.arange(200) % 2, 7, 1
    elif case == "dead_tiles":  # every other tile dead, live tiles all key 3
        keys = torch.where((torch.arange(1024) // 128) % 2 == 0, KEY["dead"], 3)
        before, after = 0, 0
    else:  # one tile, runs of 40 (key 1), 50 (key 0), 38 (key 4): sorted 50 | 40 | 38
        keys = torch.cat([torch.full((40,), 1), torch.full((50,), 0), torch.full((38,), 4)])
        before, after = 2, 2  # lane order: warps 1 (32-63: 1 and 0) and 2 (64-95: 0 and 4)
    got = TK.mixed_warps(keys)
    assert (got["mixed_before"], got["mixed_after"]) == (before, after), got
    assert got["warps"] == (keys.shape[0] + 31) // 32
    assert sum(got["lanes"].values()) == keys.shape[0]
    assert got["lanes"]["dead"] == int((keys == KEY["dead"]).sum())


def test_shade_structs_point_at_what_the_kernel_reads(lanes):
    """The launcher's structs: the pointers of `_needs` set and the others
    null (the kernel stages exactly the non-null arrays), the LUTs set, the
    flags and scalars as given; outputs on their own 16-byte aligned
    allocations."""
    tables = TL.load_tables("cpu")
    for mis, any_lights in ((True, True), (True, False), (False, True)):
        inp = port_inp(lanes)
        out = TK.empty_outputs(N, "cpu")
        ins, outs, args = TK.shade_structs(inp, (True, False, True, False), mis, any_lights, tables, out)
        needs = set(TK._needs(mis, any_lights))
        for k in TSM.V3_KEYS + TSM.F_KEYS + TSM.B_KEYS:
            assert (getattr(ins, k) or 0) == (inp[k].data_ptr() if k in needs else 0), k
        assert all(getattr(ins, k) == tables[k].data_ptr() for k in TK.LUT_KEYS)
        assert all(getattr(outs, k) == v.data_ptr() and v.data_ptr() % 16 == 0 for k, v in out.items())
        assert (args.n, args.use_metal, args.use_diel, args.use_coat, args.use_aniso, args.mis, args.any_lights) == (
            N, 1, 0, 1, 0, int(mis), int(any_lights))
        assert args.favg15 == np.float32(TSM.FAVG15) and args.reg_threshold == np.float32(0.5)
        assert len(needs) == (44 if mis and any_lights else 37)


def test_prepare_refuses_cpu_tensors(lanes):
    """The launch-only path is a CUDA path: `prepare_shade` raises on CPU
    lanes before it builds anything (the wrapper then runs the twin)."""
    inp = port_inp(lanes)
    tables = TL.load_tables("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        TK.prepare_shade(inp, (True,) * 4, True, True, tables)
    TK.COUNTS_SHADE.reset()
    TK.shade(inp, (True,) * 4, True, True, tables)
    assert TK.COUNTS_SHADE.launches == 0 and TK.COUNTS_SHADE.plain_cuda == 0
