"""The port's leveled logging (``repro_torch.telemetry.logs``) against the
reference's contract: bare messages on stdout, one knob to silence them,
records mirrored into a Recorder's JSONL log."""
import json

from repro import telemetry as jtelemetry
from repro_torch import telemetry


def test_logger_prints_bare_messages_and_mirrors_to_recorder(capsys):
    log = telemetry.get_logger("test")
    rec = telemetry.Recorder()
    telemetry.set_recorder(rec)
    try:
        log.info("[test] hello %d", 7)
    finally:
        telemetry.set_recorder(None)
    assert capsys.readouterr().out == "[test] hello 7\n"
    mirrored = [json.loads(line) for line in rec._jsonl]
    assert mirrored and mirrored[0]["kind"] == "log"
    assert mirrored[0]["msg"] == "[test] hello 7"
    assert mirrored[0]["logger"] == "test"
    assert mirrored[0]["level"] == "info"


def test_log_level_silences(capsys):
    log = telemetry.get_logger("test")
    telemetry.set_level("warning")
    try:
        log.info("[test] chatter")
        log.warning("[test] kept")
    finally:
        telemetry.set_level("info")
    assert capsys.readouterr().out == "[test] kept\n"


def test_log_file_mirrors_records(tmp_path, capsys):
    path = tmp_path / "run.log"
    telemetry.set_log_file(str(path))
    log = telemetry.get_logger("filetest")
    log.warning("[filetest] on disk")
    root = telemetry.get_logger()
    for h in list(root.handlers):
        if getattr(h, "baseFilename", None) == str(path):
            h.close()
            root.removeHandler(h)
    assert capsys.readouterr().out == "[filetest] on disk\n"
    line = path.read_text().strip()
    assert line.endswith("WARNING repro_torch.filetest: [filetest] on disk")


def test_port_logger_is_its_own_namespace(capsys):
    """The port's records do not reach the reference's logger, and the
    reference's level knob does not silence the port."""
    jtelemetry.set_level("error")
    try:
        telemetry.get_logger("ns").info("[ns] port")
    finally:
        jtelemetry.set_level("info")
    assert capsys.readouterr().out == "[ns] port\n"
    assert telemetry.get_logger("ns").name == "repro_torch.ns"
