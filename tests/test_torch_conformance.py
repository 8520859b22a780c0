"""The port's conformance sweep (llama_cpp_tpu_torch/tools/conformance.py) on
the CPU: every row of the JAX package's scripts/conformance.py, with the
reference's data (same seeds, same draws), through the plain version of the
port's kernel, against the reference's f64 oracle under its threshold,
NMSE < 5e-3. On the card the same rows go through the CUDA kernels
(chip_smoke.py, and tests/test_torch_gpu.py).

The rows are the reference's: each (kernel, config) of docs/conformance.csv
is one of the sweep's, and the sweep runs once for the module (about 20 s)."""

import csv
import os

import pytest
import torch

from llama_cpp_tpu_torch.tools import conformance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "docs", "conformance.csv")) as _f:
    REFERENCE_ROWS = [(r["kernel"], r["config"]) for r in csv.DictReader(_f)]
# K and V heads that differ (576/512): the port's attention kernels do not
# take them yet
UNTAKEN = {"mla-576", "mla-576-int8"}


@pytest.fixture(scope="module")
def swept():
    return {(r.kernel, r.config): r for r in conformance.run("cpu")}


def test_every_reference_row_is_a_row_of_the_sweep():
    """The 117 rows of the reference's CSV, in its order, among the sweep's;
    the sweep also has the three hierarchical qmm_planes rows that the
    reference's script gained after its CSV was written."""
    rows = conformance.configs()
    assert len(REFERENCE_ROWS) == 117 and len(rows) == 120 == len(set(rows))
    assert [r for r in rows if r in set(REFERENCE_ROWS)] == REFERENCE_ROWS
    assert sorted(set(rows) - set(REFERENCE_ROWS)) == [
        ("qmm_planes", "N16K2048O256g16h"), ("qmm_planes", "N8K1024O512g16h"),
        ("qmm_planes", "N8K4096O4096g32h")]


@pytest.mark.parametrize("kernel,config", conformance.configs(),
                         ids=[f"{k}-{c}" for k, c in conformance.configs()])
def test_row_holds_through_the_plain_version(swept, kernel, config):
    r = swept[(kernel, config)]
    if config in UNTAKEN:
        assert r.status == "raises" and r.nmse is None
        assert "flash_attention_paged" in r.route and "head dims" in r.route
        return
    assert r.status == "PASS", r
    assert r.nmse < conformance.NMSE_LIMIT
    assert r.route.endswith("_plain")


def test_csv_has_the_reference_columns_and_the_route(swept):
    text = conformance.to_csv(list(swept.values()), torch.device("cpu"))
    rows = list(csv.DictReader(text.splitlines()))
    assert list(rows[0]) == ["kernel", "config", "backend", "nmse", "pass", "device", "route"]
    assert len(rows) == 120 and {r["backend"] for r in rows} == {"cpu"}
    assert {r["pass"] for r in rows} == {"PASS", "raises"}
    mla = [r for r in rows if r["config"] in UNTAKEN]
    assert len(mla) == 2 and all(r["nmse"] == "" and "Dk=576" in r["route"] for r in mla)


def test_entry_point_needs_a_card_unless_told_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            conformance.main([])
    with pytest.raises(SystemExit):
        conformance.main(["--no-such-flag"])
