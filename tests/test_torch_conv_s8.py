"""The int8 3x3 conv kernel's three forms (``ops/conv_s8_cuda.py``).

CPU: the tuner's diagnostics of a WRONG reading (``utils/kernel_variants.py``:
the first differing element and the input checksums); which form each shape
takes (the int8 U-Net's main path: 13 of its 14
convs on the tensor-core form, the first conv on the first-conv form; the
narrow test networks and odd channel counts on the generic form), and the
tensor-core form's persistent tile order, which must cover every output
pixel and channel tile of a ragged batch exactly once, whatever the number
of blocks.

Card (``cuda`` marker, skipped without one): each new form bit for bit
against ``conv3x3_s8_plain`` at shapes that reach it at its edges, with the
form that ran read from ``_device.CONV_LAUNCHES``. The plain version is the
reference of these tests: its float64 sums are exact and its float32
epilogue is the JAX package's (held to JAX in ``test_torch_quant.py``).
"""

import numpy as np
import pytest
import torch

from chip_smoke import UNET_CONVS
from tissue_image_processing_tpu_torch import _device
from tissue_image_processing_tpu_torch.ops import conv_s8_cuda as tconv

# one intra-op thread: the test workers share the cores with each other
# and with XLA's device threads
torch.set_num_threads(1)


def test_first_difference_and_checksum():
    """The tuner's WRONG diagnostics: the first differing element in
    row-major order (index, got, want), None for equal tensors, the shapes
    when they differ; a checksum that changes with any one byte and
    ignores nothing of a tensor whose size is not a multiple of four."""
    from tissue_image_processing_tpu_torch.utils.kernel_variants import (
        checksum, first_difference)

    gen = torch.Generator().manual_seed(3)
    want = torch.randint(-128, 128, (2, 5, 7, 3), generator=gen,
                         dtype=torch.int8)
    got = want.clone()
    assert first_difference(got, want) is None
    got[1, 4, 2, 1] += 1
    got[1, 4, 6, 0] -= 3
    assert first_difference(got, want) == (
        (1, 4, 2, 1), int(want[1, 4, 2, 1]) + 1 if want[1, 4, 2, 1] < 127
        else -128, int(want[1, 4, 2, 1]))
    assert first_difference(got[:1], want) == ("shape", (1, 5, 7, 3),
                                               (2, 5, 7, 3))
    base = checksum(want)
    assert checksum(want.clone()) == base
    flat = want.reshape(-1)
    for k in (0, 3, flat.numel() - 1):     # the last byte lies in a padded word
        changed = flat.clone()
        changed[k] ^= 1
        assert checksum(changed.reshape(want.shape)) != base, k
    swapped = flat.clone()
    swapped[[4, 8]] = flat[[8, 4]]
    if flat[4] != flat[8]:
        assert checksum(swapped) != checksum(flat)
    f = torch.rand(9, generator=gen)
    assert checksum(f) == checksum(f.clone()) != checksum(f + 1)


def test_main_path_forms():
    """The depth-3, 128-filter network's 14 convs: 13 tensor-core launches
    and one first-conv launch a forward, as chip_smoke.py asserts."""
    forms = {}
    for (side, cin, cout, skip), n in UNET_CONVS:
        form = tconv.conv_s8_form(cin, skip, cout)
        forms[form] = forms.get(form, 0) + n
        assert form == ("first_conv" if cin == 2 else "tensor_core"), \
            (side, cin, cout, skip)
    assert forms == {"tensor_core": 13, "first_conv": 1}


@pytest.mark.parametrize("cin,skip,cout,form", [
    # test_torch_quant.py's kernel cases
    (2, 0, 128, "first_conv"), (3, 0, 24, "generic"), (32, 0, 40, "generic"),
    (128, 0, 256, "tensor_core"), (64, 64, 64, "tensor_core"),
    (16, 5, 8, "generic"), (96, 0, 136, "generic"),
    # the narrow test networks (8-32 filters) and odd channel counts
    (2, 0, 8, "generic"), (8, 0, 8, "generic"), (16, 16, 8, "generic"),
    (5, 0, 128, "first_conv"), (7, 0, 256, "first_conv"),
    (7, 0, 320, "generic"), (8, 0, 128, "generic"), (24, 0, 64, "generic"),
    (128, 64, 128, "tensor_core"), (128, 96, 128, "generic"),
    (192, 0, 128, "tensor_core")])
def test_form_of_shape(cin, skip, cout, form):
    assert tconv.conv_s8_form(cin, skip, cout) == form


@pytest.mark.parametrize("cout,split,tile", [
    (128, False, (2, 128)), (64, False, (2, 128)), (136, False, (1, 256)),
    (1024, False, (1, 256)), (128, True, (1, 128)), (512, True, (1, 128))])
def test_tc_tile_shape(cout, split, tile):
    """Two accumulator sets fit only at 128 channels; a single conv takes
    256 channels when Cout exceeds 128, else two rows a warpgroup."""
    t = tconv._tc_tiles(10, 10, cout, split)
    assert (t["mw"], t["bn"]) == tile
    assert t["tiles_n"] == -(-cout // tile[1])


@pytest.mark.parametrize("B,H,W,cout,split", [
    (1, 37, 70, 256, False), (3, 18, 66, 128, False), (2, 40, 24, 128, True),
    (1, 5, 1, 1024, False), (2, 7, 129, 136, False), (3, 1, 64, 512, True)])
@pytest.mark.parametrize("blocks", [1, 5, 132])
def test_tc_schedule_covers_each_output_once(B, H, W, cout, split, blocks):
    """Every (frame, row, column, channel tile) of the output is computed by
    exactly one block, walking tiles as the kernel does (block i takes tiles
    i, i + blocks, ...; the grid is never larger than the tile count)."""
    t = tconv._tc_tiles(H, W, cout, split)
    units = tconv._tc_units(B, t)
    blocks = min(units, blocks)
    seen = np.zeros((B, H, W, t["tiles_n"]), np.int64)
    for block in range(blocks):
        for u in range(block, units, blocks):
            b, h0, w0, n0 = tconv._tc_tile_origin(u, t)
            assert n0 % t["bn"] == 0 and w0 % tconv.TC_COLS == 0 and b < B
            seen[b, h0:h0 + 2 * t["mw"], w0:w0 + tconv.TC_COLS,
                 n0 // t["bn"]] += 1
    np.testing.assert_array_equal(seen, 1)


def test_private_route_refuses_a_form_that_does_not_fit():
    """Only the picked form or the generic one may be forced (the check
    comes before anything touches the card)."""
    x = torch.zeros(1, 4, 4, 32, dtype=torch.int8)
    wq = torch.zeros(8, 32, 3, 3, dtype=torch.int8)
    f = torch.zeros(8)
    with pytest.raises(ValueError, match="tensor_core form"):
        tconv._conv3x3_s8(x, wq, f, f, f, 1.0, 1.0, form="tensor_core")


# --- the kernel on the card --------------------------------------------------------------

def _random_conv(rng, B, H, W, cin, cout, skip_cin):
    def t(a):
        return torch.from_numpy(a).cuda()

    x = t(rng.integers(-127, 128, (B, H, W, cin)).astype(np.int8))
    skip = (t(rng.integers(-127, 128, (B, H, W, skip_cin)).astype(np.int8))
            if skip_cin else None)
    wq = t(rng.integers(-127, 128, (cout, cin + skip_cin, 3, 3)).astype(np.int8))
    K = 9 * (cin + skip_cin)
    # acc std ~ sqrt(K) * 127^2 / 3: scales that spread y over the int8 range
    wscale = t(((0.5 + rng.random(cout)) * 127.0
                / (2 * K ** 0.5 * 127 ** 2 / 3)).astype(np.float32))
    bias = t((rng.standard_normal(cout) * 0.1).astype(np.float32))
    shift = t((rng.standard_normal(cout) * 0.1).astype(np.float32))
    scales = [t(np.array(s, np.float32)) for s in (1.0, 1.3, 1.0)]
    return x, skip, wq, wscale, bias, shift, scales


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,cin,cout,skip_cin,form", [
    (1, 37, 70, 128, 256, 0, "tensor_core"),    # rows, columns ragged
    (1, 24, 40, 128, 136, 0, "tensor_core"),    # Cout past one N tile
    (1, 20, 30, 192, 128, 0, "tensor_core"),    # K chunk past a tap's Cin
    (3, 18, 66, 128, 128, 0, "tensor_core"),    # B = 3, two rows a group
    (2, 40, 24, 128, 128, 128, "tensor_core"),  # split 128 + 128
    (1, 16, 16, 1024, 1024, 0, "tensor_core"),  # deep K, four N tiles
    (2, 33, 65, 2, 128, 0, "first_conv")])      # the first conv, ragged
def test_conv3x3_s8_form_matches_plain(B, H, W, cin, cout, skip_cin, form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(B * 7 + H * 5 + cin)
    x, skip, wq, wscale, bias, shift, (s0, s1, so) = _random_conv(
        rng, B, H, W, cin, cout, skip_cin)
    kw = dict(skip=skip, skip_scale=s1 if skip_cin else None)
    _device.reset_launches()
    got = tconv.conv3x3_s8(x, wq, wscale, bias, shift, s0, so, **kw)
    assert dict(_device.CONV_LAUNCHES) == {form: 1}
    assert _device.LAUNCHES["conv3x3_s8"] == 1
    want = tconv.conv3x3_s8_plain(x, wq, wscale, bias, shift, s0, so, **kw)
    assert torch.equal(got, want)
    assert len(torch.unique(got)) > 100
    assert torch.equal(tconv.conv3x3_s8(x, wq, wscale, bias, shift, s0, so,
                                        **kw), got)
    generic = tconv._conv3x3_s8(x, wq, wscale, bias, shift, s0, so,
                                form="generic", **kw)
    assert torch.equal(generic, want)
    assert _device.CONV_LAUNCHES["generic"] == 1
