"""`python -m cice4_tpu run` with the file-free gx1-size preset (f64:
the test process runs with x64 enabled)."""

from cice4_tpu import cli


def test_cli_runs_gx1_size_preset_cut_small(tmp_path, capsys):
    d = str(tmp_path)
    rc = cli.main([
        "run", "--preset", "gx1-size", "--steps", "2", "--f64",
        "--set", "domain.nx_global=32", "--set", "domain.ny_global=24",
        "--set", "forcing.atm_data_type='analytic'",
        "--set", "run.diagfreq=2",
        "--set", f"run.history_dir='{d}/'",
        "--set", f"run.restart_dir='{d}/'",
        "--set", f"run.pointer_file='{d}/pointer'"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ran 2 steps" in out
    assert "total ice area" in out
