"""chip_smoke.py's pieces that run without a card.

The design-variant builds edit the kernel sources by text substitution
(``LANE_VARIANTS``, ``B5_VARIANTS``, ``BH_VARIANTS``, ``LRT_VARIANTS``,
``B6_LRT_VARIANTS``, ``scripts/local_classify_variants.py``); a source edit that moves the text
would only fail on the card, so these hold them here. ``row_counts`` reads
kernels that load nothing (the BH scan's zeroing kernel) as a whole.
"""

import importlib.util
import os
import re

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "sid_tpu_torch", "csrc")


def source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def local_variants():
    spec = importlib.util.spec_from_file_location(
        "local_classify_variants", os.path.join(ROOT, "scripts", "local_classify_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.VARIANTS


@pytest.mark.parametrize("name", list(chip_smoke.LANE_VARIANTS))
def test_lane_variant_texts_are_in_lynch_cu_once(name):
    src = source("lynch.cu")
    for file, old, _ in chip_smoke.LANE_VARIANTS[name]:
        assert file == "lynch.cu" and src.count(old) == 1
    chip_smoke.variant_texts(CSRC, "lynch.cu", chip_smoke.LANE_VARIANTS[name])


@pytest.mark.parametrize("name", list(local_variants()))
def test_local_classify_variant_texts_are_in_the_source_once(name):
    src = source("local_classify.cu")
    for old, _ in local_variants()[name]:
        assert src.count(old) == 1


VARIANT_TABLES = {"B5_VARIANTS": "local_classify.cu", "BH_VARIANTS": "lrt_bh.cu", "LRT_VARIANTS": "lrt_bh.cu",
                  "B6_LRT_VARIANTS": "quality_finalize.cu"}


@pytest.mark.parametrize("table, name", [(t, n) for t in VARIANT_TABLES for n in getattr(chip_smoke, t)])
def test_variant_texts_are_in_the_sources_once(table, name):
    """Each substitution of a B5, BH, LRT or B6 full variant finds its text once in the
    file it edits (after the variant's earlier substitutions) and changes
    it."""
    edits = getattr(chip_smoke, table)[name]
    texts = chip_smoke.variant_texts(CSRC, VARIANT_TABLES[table], edits)
    for file, old, new in edits:
        assert old != new
        assert new in texts[file]


@pytest.mark.parametrize("table", list(VARIANT_TABLES))
def test_variants_are_distinct(table):
    """No two variants of a table make the same sources, and only the
    committed design makes none."""
    variants = getattr(chip_smoke, table)
    made = {name: chip_smoke.variant_texts(CSRC, VARIANT_TABLES[table], edits) for name, edits in variants.items()}
    keys = [tuple(sorted(texts.items())) for texts in made.values()]
    assert len(set(keys)) == len(variants)
    assert sum(not edits for edits in variants.values()) == 1


def test_committed_b5_design_is_a_variant():
    """B5_VARIANTS holds the committed csrc/local_classify.cu as it is, so
    --b5-variants times the committed design beside the others."""
    assert [] in list(chip_smoke.B5_VARIANTS.values())
    texts = chip_smoke.variant_texts(CSRC, "local_classify.cu", [])
    assert texts == {"local_classify.cu": source("local_classify.cu")}


def test_committed_bh_design_is_a_variant():
    assert [] in list(chip_smoke.BH_VARIANTS.values())
    assert chip_smoke.variant_texts(CSRC, "lrt_bh.cu", []) == {"lrt_bh.cu": source("lrt_bh.cu")}


def test_kernel_sources_hold_no_variant_macros():
    """The variants live in chip_smoke.py's substitutions, not as build
    macros of the kernel sources."""
    for name in ("local_classify.cu", "lrt_bh.cu", "bh_sort.cuh", "quality_finalize.cu"):
        assert not re.findall(r"#if(?:n?def)? SID_(?:B5|BH|LRT)_", source(name))


@pytest.mark.parametrize("file", sorted(chip_smoke.LRT_COMMITTED))
def test_lrt_committed_constants_are_the_sources(file):
    """LRT_COMMITTED holds the row kernels' committed launch bounds, and
    each variant's text asks for its own."""
    blocks = chip_smoke.LRT_COMMITTED[file]
    src = source(file)
    assert src.count(f"constexpr int kLrtMinBlocks = {blocks};") == 1
    table = chip_smoke.LRT_VARIANTS if file == "lrt_bh.cu" else chip_smoke.B6_LRT_VARIANTS
    assert len(table) == 5
    for name, edits in table.items():
        text = chip_smoke.variant_texts(CSRC, file, edits)[file]
        assert f"constexpr int kLrtMinBlocks = {name.split()[0]};" in text
        assert (edits == []) == name.endswith("(committed)")


def test_planted_edges_keep_the_arrays():
    """plant_edges copies both arrays and plants every pair of its 13 edge
    values once, at distinct rows."""
    import numpy as np

    a, b = np.linspace(-10, -1, 1000), np.linspace(-20, -2, 1000)
    x, y = chip_smoke.plant_edges(a, b)
    changed = (x != a) | (y != b) | np.isnan(x) | np.isnan(y)
    assert 13 * 13 - 13 <= changed.sum() <= 13 * 13
    assert np.array_equal(a, np.linspace(-10, -1, 1000))


def test_row_counts_of_a_kernel_that_loads_nothing():
    """A zeroing kernel has no load to anchor a row: the whole kernel."""
    instrs = [(0x00, False, "S2R", "R0, SR_TID.X"), (0x10, True, "STG", "desc[UR4][R2.64], RZ"),
              (0x20, False, "EXIT", ""), (0x30, False, "BRA", "0x30")]
    got = chip_smoke.row_counts(instrs)
    assert got == {"f64": 0, "issued": 4, "f64_all": 0, "issued_all": 4}


def test_row_counts_of_a_row_loop():
    """The loop around the first load is the row; a branch jumping over an
    instruction takes it out of the every-row count."""
    instrs = [(0x00, False, "S2R", ""), (0x10, False, "LDG", ""), (0x20, False, "DADD", ""),
              (0x30, False, "BRA", "0x50"), (0x40, False, "DMUL", ""), (0x50, False, "BRA", "0x10"),
              (0x60, False, "EXIT", "")]
    got = chip_smoke.row_counts(instrs)
    assert (got["f64"], got["f64_all"]) == (1, 2)
