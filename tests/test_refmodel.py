"""Reference-model head-to-head regression (native/refmodel.h).

The refmodel side-car prices every recorded bin under a faithful
reimplementation of the reference's h264_model (reference
recode.cpp:616-1059); tools/ref_head2head.py publishes the full table.
This test locks in (a) the side-car runs and produces a sane total, and
(b) the product model's payload never exceeds the reference model's on a
real x264 stream — the measured form of BASELINE.md's ratio claim.

Runs in a subprocess: ARTC_REFMODEL latches once per process inside
run_chunk_model, and the main pytest process must keep it off.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, sys
sys.path.insert(0, %(repo)r)
from avrecode_jax import host
data = open(%(clip)r, 'rb').read()
blob, st = host.compress(data)
ours = st.bill['nz']['bytes'] + sum(st.bill[k]['bytes'] for k in host.KLASS_NAMES)
print(json.dumps({'ours': ours, 'ref': st.ref_model_bytes,
                  'bins': st.total_bins, 'ok': len(blob) < len(data)}))
"""


def test_refmodel_side_car_and_win(corpus_dir):
    clip = os.path.join(corpus_dir, "ipb_high.264")
    env = dict(os.environ, ARTC_REFMODEL="1", ARTC_SECTION_BINS="4000000000")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD % {"repo": REPO, "clip": clip}],
        env=env, capture_output=True, text=True, check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["ok"]
    assert r["bins"] > 1000
    # The side-car actually ran and produced a plausible total (the reference
    # model codes the same bins plus its NZ bits; anything near-zero or
    # enormous means the hook broke).
    assert 0.2 * r["ours"] < r["ref"] < 5 * r["ours"]
    # The measured head-to-head: our model never pays more than the
    # reference's on this stream.
    assert r["ours"] <= r["ref"]


def test_refmodel_off_reports_zero(corpus_dir):
    clip = os.path.join(corpus_dir, "ipb_high.264")
    env = dict(os.environ)
    env.pop("ARTC_REFMODEL", None)
    out = subprocess.run(
        [sys.executable, "-c", _CHILD % {"repo": REPO, "clip": clip}],
        env=env, capture_output=True, text=True, check=True)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["ref"] == 0.0
