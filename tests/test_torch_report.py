"""``repro_torch.launch.report`` against the reference's
``repro.launch.report``: the same text on the same ok / skip / error /
timeout records, but for the fits column's header, which names the
records' HBM (80 GB for the port's records)."""
import json

import pytest

from repro.launch import report as RREP
from repro_torch.launch import report as PREP


def _ok(arch, shape, kind, peak, **extra):
    return {"arch": arch, "shape": shape, "mesh_kind": kind, "status": "ok",
            "memory": {"peak_bytes": peak}, "hbm_util": peak / 16e9, "fits_hbm": peak < 16e9,
            "compile_s": 12.3, "collectives_by_kind": {"all-gather": 3.5e9, "all-reduce": 1e6},
            "compute_s": 0.0123, "memory_floor_s": 4.5e-4, "collective_s": 2.5e-7,
            "dominant": "compute_s", "useful_flops_ratio": 0.45, "roofline_fraction": 0.3,
            **extra}


RECORDS = [
    _ok("gemma2-9b", "train_4k", "pod", 7.5e9),
    _ok("gemma2-9b", "train_4k", "multipod", 2.1e10, collectives_by_kind={}),
    _ok("arctic-480b", "decode_32k", "pod", 3e12, compute_s=2.0, memory_floor_s=0.0,
        dominant="memory_floor_s", useful_flops_ratio=None, roofline_fraction=None),
    {"arch": "gemma-7b", "shape": "long_500k", "mesh_kind": "pod", "status": "skip",
     "skip_reason": "long_500k needs sub-quadratic attention; gemma-7b has unbounded-context "
                    "layers (DESIGN.md §Arch-applicability)"},
    {"arch": "qwen1.5-32b", "shape": "train_4k", "mesh_kind": "multipod", "status": "error",
     "error": "Traceback ..."},
    {"arch": "arctic-480b", "shape": "train_4k", "mesh_kind": "pod", "status": "timeout",
     "timeout_s": 1800},
]


def _write(tmp_path, records):
    for i, r in enumerate(records):
        (tmp_path / f"{i:02d}__{r['arch']}__{r['shape']}__{r['mesh_kind']}.json").write_text(
            json.dumps(r))


def _main(module, tmp_path, capsys, monkeypatch) -> str:
    monkeypatch.setattr("sys.argv", ["report", "--dir", str(tmp_path)])
    module.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("table", ["dryrun", "pod", "multipod"])
def test_tables_equal_the_reference(table):
    if table == "dryrun":
        assert PREP.dryrun_table(RECORDS) == RREP.dryrun_table(RECORDS)
    else:
        assert PREP.roofline_table(RECORDS, table) == RREP.roofline_table(RECORDS, table)


def test_main_equals_the_reference(tmp_path, capsys, monkeypatch):
    _write(tmp_path, RECORDS)
    assert PREP.load(str(tmp_path)) == RREP.load(str(tmp_path))
    want = _main(RREP, tmp_path, capsys, monkeypatch)
    assert "fits 16G" in want
    assert _main(PREP, tmp_path, capsys, monkeypatch) == want


def test_port_records_name_their_hbm(tmp_path, capsys, monkeypatch):
    """The port's records carry ``hbm_bytes`` (80 GB): the header says so,
    every other byte is the reference's."""
    records = [dict(r, hbm_bytes=80e9) if r["status"] == "ok" else r for r in RECORDS]
    _write(tmp_path, records)
    want = _main(RREP, tmp_path, capsys, monkeypatch)
    got = _main(PREP, tmp_path, capsys, monkeypatch)
    assert got == want.replace("| fits 16G |", "| fits 80G |") and got != want
