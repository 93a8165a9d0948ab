"""``analysis/knobs.py`` against the JAX package's auditor: the same rule
ids at the same places on the same fixture sources (a README holding only
the port's section, which is what the port reads of it), the port's tree
clean, and the concurrency fixtures' gates counted as reads."""

import os
import textwrap

import pytest

from alphafold2_tpu.analysis import knobs as jknobs
from alphafold2_tpu_torch.analysis import knobs

CONFIG = """
    from dataclasses import dataclass

    @dataclass
    class FooConfig:
        live_field: int = 1  # documented inline
        dead_field: int = 2  # referenced nowhere
        # block comment above counts as documentation
        dead_but_commented: int = 3
        naked_dead: int = 4
"""

CASES = {
    # name: (code, README text after the port's heading)
    "undocumented": ('import os\nX = os.environ.get("AF2TPU_FAKE_KNOB")\n', "nothing here\n"),
    "dead_doc": ("", "set `AF2TPU_GHOST_KNOB=1` to do nothing\n"),
    "prefix_family": ('import os\nPREFIX = "AF2TPU_FAM_"\n'
                      'vals = {k: v for k, v in os.environ.items() if k.startswith(PREFIX)}\n',
                      "`AF2TPU_FAM_` prefix family: `AF2TPU_FAM_ALPHA`, `AF2TPU_FAM_BETA`\n"),
    "config_fields": ("def use(c):\n    return c.live_field\n", ""),
    "documented": ('import os\nY = os.environ["AF2TPU_REAL"]\n', "`AF2TPU_REAL` is real\n"),
}


def _paths(tmp_path, code, readme, config=""):
    (tmp_path / "mod.py").write_text(code)
    (tmp_path / "README.md").write_text(f"# x\n\n{knobs.README_SECTION}\n\n{readme}\n")
    (tmp_path / "config.py").write_text(textwrap.dedent(config))
    return dict(code_paths=[str(tmp_path / "mod.py")], liveness_paths=[str(tmp_path / "mod.py")],
                readme_path=str(tmp_path / "README.md"), config_path=str(tmp_path / "config.py"))


def _ids(findings):
    return sorted((f.rule, os.path.basename(f.path), f.line) for f in findings)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_ids_match_jax_on_the_same_fixture(case, tmp_path):
    code, readme = CASES[case]
    kw = _paths(tmp_path, code, readme, CONFIG if case == "config_fields" else "")
    ours, theirs = knobs.audit(**kw), jknobs.audit(**kw)
    assert _ids(ours) == _ids(theirs)
    assert knobs.RULES == jknobs.RULES
    want = {"undocumented": ["AF2K001"], "dead_doc": ["AF2K002"], "prefix_family": [],
            "config_fields": ["AF2K003"] * 3 + ["AF2K004"], "documented": []}[case]
    assert sorted(f.rule for f in ours) == want


def test_only_the_port_section_documents(tmp_path):
    kw = _paths(tmp_path, 'import os\nX = os.environ.get("AF2TPU_FAKE_KNOB")\n', "")
    with open(kw["readme_path"], "a") as fh:
        fh.write("\n## Another section\n\n`AF2TPU_FAKE_KNOB` documented out of the section\n")
    assert [f.rule for f in knobs.audit(**kw)] == ["AF2K001"]


def test_gated_defect_markers_are_reads(tmp_path):
    code = ("def _fixture():  # af2: gated-defect[AF2TPU_AUDIT_SOMETHING]\n"
            "    pass\n")
    kw = _paths(tmp_path, code, "")
    assert [f.message.split()[2] for f in knobs.audit(**kw)] == ["AF2TPU_AUDIT_SOMETHING"]
    reads = knobs.collect_env_reads(knobs.default_code_paths())
    assert {"AF2TPU_AUDIT_FLEET_LOCK", "AF2TPU_AUDIT_INVERT_LOCKS"} <= set(reads)


def test_port_tree_is_clean_and_the_registry_covers_every_read(capsys):
    assert knobs.audit() == []
    reads = knobs.collect_env_reads(knobs.default_code_paths())
    assert "AF2TPU_KERNELS" in reads and "AF2TPU_TRACE_EVENTS" in reads
    # chip_smoke.py's fleet phase sets it to check that an incident file
    # redacts a secret-shaped variable: the port reads it, the README's
    # port section documents it
    assert "AF2TPU_FLEET_SMOKE_TOKEN" in reads
    md = knobs.markdown_registry(reads)
    for name in reads:
        assert f"`{name}`" in md
    assert knobs.main([]) == 0
    assert "knob audit clean" in capsys.readouterr().out
