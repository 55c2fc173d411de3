"""The JAX package's static concurrency and state-machine checks over the
port, unedited: ``analysis/racecheck.analyze_paths`` (lock order,
``# guarded_by:`` discipline, blocking calls under a lock) and
``analysis/statecheck.analyze_paths`` (the control-plane state machines:
the rollout's, the controller's ladder, the breakers) over
``robotic_discovery_platform_tpu_torch/``.

The test passes with no finding, or with findings that the baseline below
names, each with the reason it stays. An entry is matched by file, rule
and the text of the flagged line, so it follows the line when code moves;
an entry that no longer matches a finding fails the test, so the baseline
only shrinks.
"""

from pathlib import Path

from robotic_discovery_platform_tpu.analysis import racecheck, statecheck

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "robotic_discovery_platform_tpu_torch"

#: (file under the port, rule, the flagged line's text) -> why it stays
BASELINE = {
    ("ops/build.py", "RC003", "proc.wait()"): (
        "build._lock serializes the kernel builds: a thread that needs a "
        "library being built has to wait for that build in any case. This "
        "wait() is in the clean-up path, right after kill(): it reaps an "
        "nvcc process that has just been killed, so it returns at once."),
}


def _key(finding) -> tuple:
    path = Path(finding.file)
    if not path.is_absolute():
        path = REPO / path
    line = path.read_text().splitlines()[finding.line - 1].strip()
    return (path.relative_to(PORT).as_posix(), finding.rule, line)


def _check(findings) -> None:
    live = [f for f in findings if _key(f) not in BASELINE]
    assert not live, "\n".join(
        f"{f.file}:{f.line}: {f.rule} {f.message}" for f in live)
    matched = {_key(f) for f in findings}
    stale = [k for k in BASELINE if k not in matched]
    assert not stale, f"baseline entries without a finding: {stale}"


def test_racecheck_over_the_port_finds_nothing_unexplained():
    result = racecheck.analyze_paths([str(PORT)])
    assert result.modules  # the port was parsed
    _check(result.findings)
    # the new threads carry their notes: the placer's and the rollout's
    # fields are declared guarded, and the grace-stop scheduler says its
    # caller holds the reload lock
    text = {p: (PORT / p).read_text() for p in (
        "serving/zoo.py", "serving/rollout.py", "serving/server.py")}
    assert text["serving/zoo.py"].count("# guarded_by: _lock") >= 4
    assert text["serving/rollout.py"].count("# guarded_by: _lock") >= 7
    assert ("_schedule_grace_stop(self, dispatcher: BatchDispatcher) -> "
            "None:  # guarded_by: _reload_lock") in text["serving/server.py"]


def test_statecheck_over_the_port_finds_nothing():
    findings = statecheck.analyze_paths([str(PORT)])
    assert not findings, "\n".join(
        f"{f.file}:{f.line}: {f.rule} {f.message}" for f in findings)


def test_every_baseline_entry_has_a_reason():
    for key, reason in BASELINE.items():
        assert len(reason) > 40, key
