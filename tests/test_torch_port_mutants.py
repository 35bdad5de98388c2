"""The faults that chip_smoke.py plants in copies of the kernels' sources
stay plantable: each K2_MUTANTS and K3_MUTANTS text occurs exactly once in
its kernel's source, so a rewrite that orphans one fails here and not on
the card. The faults that target the bf16 convolutions must sit in the
bf16 code (the wgmma kernels), not in the fp32 path that bf16 never runs;
those that target K2's stage 1 must sit in its templated code, which both
dtypes run, before the wgmma kernels; those that target K2's stage 7 in
its templated code after the stage-7 banner, which both dtypes run too.
"""

from pathlib import Path

import pytest

from chip_smoke import K2_MUTANTS, K2_STAGE1_FAULTS, K2_STAGE7_FAULTS, K3_MUTANTS

CSRC = Path(__file__).resolve().parent.parent / "raft_stereo_tpu_torch" / "csrc"

# kernel source, the marker that opens its wgmma bf16 conv, and the faults
# planted in that conv (the rest target code both dtypes run)
KERNELS = {
    "fused_update": ("fused_update.cu", "conv_sm90(const ConvArgs args",
                     {"inp16_chunk_dropped", "z_cast_added", "top_row_dropped"}),
    "packed_conv": ("packed_conv.cu", "packed_conv_sm90(const Args args,",
                    {"prologue_on_padding", "prologue_mul_rounding_skipped",
                     "bottom_row_dropped"}),
}
# the banners that open K2's stage 1 (the lookup with convc1 and convf1)
# and stage 7 (the flow head's conv2)
STAGE1_MARKER = "// " + "-" * 64 + " stage 1\n"
STAGE7_MARKER = "// " + "-" * 64 + " stage 7\n"
CASES = ([("fused_update", *m) for m in K2_MUTANTS]
         + [("packed_conv", *m) for m in K3_MUTANTS])


@pytest.mark.parametrize("kernel,name,text,replacement", CASES, ids=[c[1] for c in CASES])
def test_planted_fault_text_occurs_once(kernel, name, text, replacement):
    src = (CSRC / KERNELS[kernel][0]).read_text()
    assert src.count(text) == 1, f"{name}: its text occurs {src.count(text)} times"
    assert replacement != text and src.replace(text, replacement) != src


@pytest.mark.parametrize("kernel,name,text,replacement", CASES, ids=[c[1] for c in CASES])
def test_bf16_faults_sit_in_the_wgmma_kernel(kernel, name, text, replacement):
    path, marker, bf16_faults = KERNELS[kernel]
    src = (CSRC / path).read_text()
    start = src.index(marker)
    if name in bf16_faults:
        assert src.index(text) > start, f"{name} is planted before the bf16 kernel"
    elif kernel == "fused_update" and name in K2_STAGE7_FAULTS:  # both dtypes run stage 7
        stage7 = src.index(STAGE7_MARKER)
        assert start < stage7 < src.index(text) < src.index('extern "C"'), (
            f"{name} is planted outside stage 7")
        assert "template <typename T" in src[stage7:src.index(text)]
    else:  # stage 1 of K2, which runs in both dtypes
        assert name in K2_STAGE1_FAULTS
        stage1 = src.index(STAGE1_MARKER)
        assert stage1 < src.index(text) < start, f"{name} is planted outside stage 1"
        assert "template <typename T" in src[:src.index(text)]


def test_every_fault_class_is_planted():
    """The fault classes the checks must catch: a dropped input chunk, a
    skipped rounding point, a cast added to z, a padding row read wrong, the
    prologue applied to the padding, in stage 1's staging a chunk of
    channels never copied and a level row staged short, and in stage 7 a
    tile's halo column read as zero, a channel vector never loaded, halo
    rows read across a batch edge and the shift-add's taps transposed."""
    names = {m[0] for m in K2_MUTANTS} | {m[0] for m in K3_MUTANTS}
    assert {"inp16_chunk_dropped", "flow_cast_skipped", "z_cast_added", "top_row_dropped",
            "bottom_row_dropped", "prologue_on_padding",
            "prologue_mul_rounding_skipped", "last_chunk_unstaged",
            "level_row_short", "right_halo_column_zero", "last_vector_unloaded",
            "next_image_halo_rows", "shift_add_taps_transposed"} <= names
    assert set(K2_STAGE1_FAULTS) <= {m[0] for m in K2_MUTANTS}
    assert set(K2_STAGE7_FAULTS) <= {m[0] for m in K2_MUTANTS}
    assert not set(K2_STAGE1_FAULTS) & set(K2_STAGE7_FAULTS)
