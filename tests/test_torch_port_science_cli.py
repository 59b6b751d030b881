"""The port's ``science`` command line (``attackfl_tpu_torch/science/cli.py``)
against the JAX package's jax-free ``attackfl_tpu.science.cli``, on the
committed ``tests/data/science_corpus`` (three synthetic sweeps: ``base-a``
and ``base-b`` rank the defenses alike, ``flip`` swaps two of them).

``leaderboard`` (with ``--outcomes``, ``--json``, a sweep prefix and an
unknown sweep), ``report`` (to stdout and ``--out``) and ``diff`` (with
``--gate``: a clean pair, a rank flip, the two newest sweeps, an unknown
sweep, an empty ledger) give JAX's stdout, files and exit codes, and
``python -m attackfl_tpu_torch science`` reaches the same command.
"""

from pathlib import Path

import pytest
from _torch_port_threads import one_torch_thread  # noqa: F401

from attackfl_tpu.science import cli as jcli
from attackfl_tpu_torch import cli as port_cli
from attackfl_tpu_torch.science import cli

CORPUS = str(Path(__file__).resolve().parent / "data" / "science_corpus")


def _both(argv, capsys):
    """``(stdout, exit code)`` of the port's and JAX's command on ``argv``."""
    out = []
    for main in (cli.main, jcli.main):
        try:
            rc = main(list(argv))
        except SystemExit as e:
            rc = e.code
        out.append((capsys.readouterr().out, rc))
    return out


CASES = [
    ["leaderboard"], ["leaderboard", "--json"], ["leaderboard", "--outcomes"],
    ["leaderboard", "--outcomes", "--json"], ["leaderboard", "--sweep-id", "base-b"],
    ["leaderboard", "--sweep-id", "bas"], ["leaderboard", "--sweep-id", "nope"],
    ["leaderboard", "--bootstrap", "50", "--boot-seed", "3", "--json"],
    ["report"], ["report", "--sweep-id", "flip", "--bootstrap", "20"],
    ["diff", "base-a", "base-b", "--gate"], ["diff", "base-a", "base-b", "--json"],
    ["diff", "base-a", "flip", "--gate"], ["diff", "base-a", "flip", "--gate", "--json"],
    ["diff", "--gate"], ["diff", "base-a", "nope", "--gate"],
    ["diff", "base-a", "flip", "--gate", "--damage-floor", "0.5"],
]


@pytest.mark.parametrize("argv", CASES, ids=" ".join)
def test_science_commands_as_jaxs_on_the_corpus(argv, capsys):
    (port, port_rc), (jax, jax_rc) = _both(argv + ["--dir", CORPUS], capsys)
    assert port == jax
    assert port_rc == jax_rc


def test_gate_verdicts():
    """The corpus's pairs reach each exit code of the gate."""
    assert cli.main(["diff", "base-a", "base-b", "--gate", "--dir", CORPUS]) == 0
    assert cli.main(["diff", "base-a", "flip", "--gate", "--dir", CORPUS]) == 1
    assert cli.main(["diff", "base-a", "nope", "--gate", "--dir", CORPUS]) == 2


def test_report_file_as_jaxs(tmp_path, capsys):
    rcs = [main(["report", "--out", str(tmp_path / f"{name}.json"), "--dir", CORPUS])
           for name, main in (("port", cli.main), ("jax", jcli.main))]
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert rcs == [0, 0]
    assert port_line.replace("port.json", "") == jax_line.replace("jax.json", "")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


def test_empty_ledger_exits_2(tmp_path, capsys):
    (port, port_rc), (jax, jax_rc) = _both(["leaderboard", "--dir", str(tmp_path)], capsys)
    assert port == jax and port_rc == jax_rc == 2


def test_the_ports_command_line_reaches_science(capsys):
    assert port_cli.main(["science", "leaderboard", "--dir", CORPUS]) == 0
    port = capsys.readouterr().out
    assert jcli.main(["leaderboard", "--dir", CORPUS]) == 0
    assert port == capsys.readouterr().out
