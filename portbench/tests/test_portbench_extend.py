"""A configuration's benchmark side is added by files and entries alone.

A copy of the harness gets what a configuration with a new codec brings:
a plain entropy decoder with its roofline work, a plain inverse transform,
a roofline metric of the codec's kernel and a metric that reads the
program's spans, and their `per_layer` entries in BENCHMARK.json. The
copy's own CPU tests must pass with no other edit, and the copy must
differ from the tree by nothing but what was added.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
STUB_ENTROPY = 31      # a 5-bit entropy id that kanzi leaves unused
STUB_TRANSFORM = 63    # a 6-bit transform id that kanzi leaves unused

ADDED = {
    "reference/entropy/stub.py": f'''"""A stub codec: the payload is the block's bytes."""

IDS = ({STUB_ENTROPY},)


def decode(bits, length):
    return bits.read_bytes(length)


def work(payload_bytes, out_bytes):
    return payload_bytes + out_bytes, out_bytes
''',
    "reference/transform/stub.py": f'''"""A stub transform: its inverse is the identity."""

IDS = ({STUB_TRANSFORM},)


def inverse(data):
    return data
''',
    "metrics/stub_decode_roofline.py": f'''"""The stub kernel's share of its roofline, in %."""

from portbench import peaks


def read(run):
    return peaks.roofline_percent(run, {STUB_ENTROPY}, ("stub_decode_kernel",))
''',
    "metrics/stub_ms_per_MiB.decode.py": '''"""The program's stub spans, ms per MiB returned."""

from portbench import measure


def read(run):
    return measure.span_ms_per_mib(run, "kanzi.stub")
''',
}
ENTRIES = [
    {"name": "stub_decode_roofline", "unit": "%", "better": "higher", "source": "device_trace",
     "layer": "kernels", "moves": "decompress_MBps", "workloads": ["range.archive"]},
    {"name": "stub_ms_per_MiB.decode", "unit": "ms/MiB", "better": "lower",
     "source": "program_span", "layer": "host runtime", "moves": "decompress_MBps",
     "workloads": ["range.archive"]},
]


def files(top):
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, names in os.walk(top)
                  for f in names if "__pycache__" not in d.split(os.sep))


def test_a_new_codec_and_its_metrics_by_added_files_alone(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in ADDED.items():
        path = copy / rel
        assert not path.exists(), rel
        path.write_text(text)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    added = dict(bench, per_layer=bench["per_layer"] + ENTRIES)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added, indent=2))

    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONDONTWRITEBYTECODE="1")
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "-m", "not gpu",
         "-o", "markers=gpu: needs a CUDA card", "-o", "addopts=",
         "--ignore", os.path.join("portbench", "tests", os.path.basename(__file__)),
         os.path.join("portbench", "tests")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-2000:]
    # the copy's tests read the copy: its registry and its metrics
    for case in (f"test_roofline_reads_100_at_its_own_bound_and_no_more[{STUB_ENTROPY}]",
                 "test_every_metric_has_a_reader_that_reads_a_run_or_nothing"
                 "[stub_decode_roofline]",
                 "test_every_metric_has_a_reader_that_reads_a_run_or_nothing"
                 "[stub_ms_per_MiB.decode]"):
        assert f"{case} PASSED" in p.stdout, case

    # nothing but the added files and entries
    assert files(copy) == sorted(files(HERE) + list(ADDED))
    for rel in files(HERE):
        assert filecmp.cmp(os.path.join(HERE, rel), copy / rel, shallow=False), rel
    assert json.loads((tmp_path / "BENCHMARK.json").read_text()) == \
        dict(bench, per_layer=bench["per_layer"] + ENTRIES)
