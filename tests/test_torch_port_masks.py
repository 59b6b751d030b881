"""K3's layout and plain version (``ops/fused_step.fill_masks``,
``dropout_masks``, ``mask_layout``) and the xla path's one draw per step
(``training/local.step_masks`` of the model's ``mask_specs``), on the CPU.
Each spec is ``(tensor_id, rows, width, rate)``: the tensors of one launch
each have their own row count.

On the CPU ``fill_masks`` takes the plain version, which fills the same
arena as the kernel, so these tests hold the layout as well as the bits:
every mask is bit-equal to ``dropout_mask`` of its tensor, and every
tensor is a contiguous view of one arena starting 16-byte aligned.  The
kernel itself is held against the plain version on the card
(tests/test_torch_port_kernel_cuda.py, chip_smoke.py).
"""

import pytest
import torch
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu_torch.models.icu import TransformerModel
from attackfl_tpu_torch.ops import fused_step as tfs
from attackfl_tpu_torch.training import local

MODEL = TransformerModel()
WIDTHS = dict(heads=4, ff=6, width=64)
STEP_RATES = (0.1, 0.1, 0.3)


def _step_specs(rows, rates):
    return MODEL.mask_specs([(rows, 7), (rows, 16)], rates)


# (clients, specs): a config-4 step's nine tensors at a small size, then
# odd shapes (widths not a multiple of 4, one row, one column), then mixed
# row counts in one launch
CASES = {
    "step C=4 B=32": (4, _step_specs(32, STEP_RATES)),
    "C=3 rows 7 widths 5, 1, 6": (3, [(16, 7, 5, 0.1), (17, 7, 1, 0.3), (18, 7, 6, 0.5)]),
    "one row and one column": (1, [(24, 1, 1, 0.1)]),
    "C=5 one row": (5, [(16, 1, 1, 0.1), (17, 1, 5, 0.3), (24, 1, 3, 0.7)]),
    "C=3 mixed rows": (3, [(16, 9, 9, 0.1), (17, 45, 5, 0.1), (18, 45, 7, 0.1),
                           (24, 5, 4, 0.3), (19, 1, 3, 0.5)]),
}

# the tensor ids, widths and order of the xla path's nine masks, written
# out: per branch (attention, attention output, FFN hidden, FFN output),
# then the head
PATH_MASKS = {"vitals": ((16, "heads", 0), (17, "width", 1), (18, "ff", 1), (19, "width", 1)),
              "labs": ((20, "heads", 0), (21, "width", 1), (22, "ff", 1), (23, "width", 1)),
              "head": ((24, "width", 2),)}


def _keys(C, seed=2024, step=5):
    return tfs.client_keys(seed, step, torch.arange(C))


@pytest.mark.parametrize("case", CASES)
def test_fill_masks_on_cpu_is_bit_equal_to_dropout_mask(case):
    C, specs = CASES[case]
    keys = _keys(C)
    before = tfs.fill_masks.launches
    got = tfs.fill_masks(keys, specs)
    assert tfs.fill_masks.launches == before
    assert len(got) == len(specs)
    for mask, (tensor_id, rows, width, rate) in zip(got, specs):
        assert torch.equal(mask, tfs.dropout_mask(keys, tensor_id, rows, width, rate))


@pytest.mark.parametrize("case", CASES)
def test_masks_are_aligned_views_of_one_arena(case):
    C, specs = CASES[case]
    got = tfs.fill_masks(_keys(C), specs)
    offsets, total = tfs.mask_layout(C, [(r, w) for _, r, w, _ in specs])
    storage = got[0].untyped_storage()
    assert storage.nbytes() == 4 * total
    for mask, offset, (_, rows, width, _) in zip(got, offsets, specs):
        assert mask.untyped_storage().data_ptr() == storage.data_ptr()
        assert mask.is_contiguous() and mask.dtype == torch.float32
        assert tuple(mask.shape) == (C, rows, width)
        assert mask.storage_offset() == offset and (4 * offset) % 16 == 0
    # the segments follow each other in order and never overlap
    ends = [o + C * r * w for o, (_, r, w, _) in zip(offsets, specs)]
    assert all(e <= o for e, o in zip(ends, offsets[1:])) and ends[-1] == total


def test_mask_layout_rounds_each_offset_up_to_a_quad():
    assert tfs.mask_layout(3, [(7, 5), (7, 1), (7, 6)]) == ([0, 108, 132], 258)
    assert tfs.mask_layout(100, [(128, 4), (128, 64)]) == ([0, 51200], 870400)
    assert tfs.mask_layout(3, [(9, 9), (45, 5), (1, 3)]) == ([0, 244, 920], 929)


@pytest.mark.parametrize("rates", [STEP_RATES, (0.5, 0.2, 0.7), (0.0, 0.1, 0.3)])
def test_step_masks_are_the_nine_per_tensor_masks(rates):
    """The path's bits did not change: tensor by tensor, ``step_masks``
    gives what one ``dropout_mask`` call per tensor gives."""
    C, rows = 4, 32
    keys = _keys(C, seed=11, step=3)
    masks = local.step_masks(keys, _step_specs(rows, rates))
    assert len(masks) == sum(len(t) for t in PATH_MASKS.values())
    drawn = iter(masks)
    for name, tensors in PATH_MASKS.items():
        for (tensor_id, cols, which), mask in zip(tensors, drawn):
            rate = rates[which]
            want = (tfs.dropout_mask(keys, tensor_id, rows, WIDTHS[cols], rate) if rate > 0.0
                    else torch.ones(C, rows, WIDTHS[cols]))
            assert torch.equal(mask, want), (name, tensor_id)


BAD_INPUTS = {
    "int32 keys": (lambda k: (k.to(torch.int32), [(16, 8, 4, 0.1)]), "int64"),
    "2-D keys": (lambda k: (k.reshape(1, -1), [(16, 8, 4, 0.1)]), "int64"),
    "no keys": (lambda k: (k[:0], [(16, 8, 4, 0.1)]), "empty"),
    "no rows": (lambda k: (k, [(16, 8, 4, 0.1), (17, 0, 4, 0.1)]), "empty"),
    "a width of 0": (lambda k: (k, [(16, 8, 4, 0.1), (17, 8, 0, 0.1)]), "empty"),
    "rate 0": (lambda k: (k, [(16, 8, 4, 0.0)]), "rate"),
    "rate 1": (lambda k: (k, [(16, 8, 4, 0.1), (17, 8, 4, 1.0)]), "rate"),
    "no specs": (lambda k: (k, []), "1 to 16"),
    "17 specs": (lambda k: (k, [(t, 8, 4, 0.1) for t in range(17)]), "1 to 16"),
    "2^31 elements": (lambda k: (k[:1], [(16, 8, 4, 0.1), (17, 2 ** 16, 2 ** 15, 0.1)]),
                      "2\\^31"),
    "meta keys": (lambda k: (k.to("meta"), [(16, 8, 4, 0.1)]), "cuda or cpu"),
}


@pytest.mark.parametrize("bad", BAD_INPUTS)
def test_fill_masks_checks_inputs(bad):
    make, match = BAD_INPUTS[bad]
    with pytest.raises(ValueError, match=match):
        tfs.fill_masks(*make(_keys(3)))


def test_sixteen_specs_fill_in_one_call():
    keys = _keys(2)
    specs = [(t, 1 + t % 4, 1 + t % 5, 0.1 + 0.05 * (t % 3)) for t in range(tfs.MAX_MASKS)]
    got = tfs.fill_masks(keys, specs)
    for mask, (tensor_id, rows, width, rate) in zip(got, specs):
        assert torch.equal(mask, tfs.dropout_mask(keys, tensor_id, rows, width, rate))


@pytest.mark.parametrize("rates,drawn", [
    ((0.0, 0.1, 0.0), [17, 18, 19, 21, 22, 23]),
    ((0.1, 0.0, 0.0), [16, 20]),
    ((0.0, 0.0, 0.3), [24]),
    (STEP_RATES, list(range(16, 25))),
])
def test_rate_zero_tensors_are_left_out_of_the_launch(monkeypatch, rates, drawn):
    calls = []
    fill = tfs.fill_masks

    def spy(keys, specs):
        calls.append([t for t, _, _, _ in specs])
        return fill(keys, specs)

    monkeypatch.setattr(tfs, "fill_masks", spy)
    local.step_masks(_keys(2), _step_specs(8, rates))
    assert calls == [drawn]
    assert local.step_masks(_keys(2), _step_specs(8, (0.0, 0.0, 0.0))) is None
    assert calls == [drawn]
