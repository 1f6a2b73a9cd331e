"""How the latency cells hand frames to the program: the live camera and
the fleet's round buffers carry each pair's frames as the sequence holds
them, at 60x80 on the CPU."""

import numpy as np
import torch

from benchmark import drivers
from benchmark.drivers import fleet
from benchmark.tests.helpers import small_run


def test_the_live_camera_hands_each_pair_its_own_frames(monkeypatch):
    handed = []
    object_api = drivers.Program.object_api

    def recording(self):
        vo = object_api(self)
        for name in ("set_source_frame", "set_target_frame"):
            def setter(intensity, depth, set_frame=getattr(vo, name)):
                handed.append((intensity.copy(), depth.copy()))
                set_frame(intensity, depth)
            setattr(vo, name, setter)
        return vo

    monkeypatch.setattr(drivers.Program, "object_api", recording)
    rec = small_run("ceres5.live", seed=2**36 + 11, keep=True)
    assert rec["correct"], rec["checks"]
    I8, D16 = rec["seq"]
    scale = np.float32(1.0 / rec["config"]["camera"]["depth_counts_per_m"])
    pairs = rec["chains"][0]["pairs"]
    window = handed[-2 * len(pairs):]  # the warm-up's pairs come first
    for (src, tgt), (si, sd), (ti, td) in zip(pairs, window[0::2], window[1::2]):
        for f, (i, d) in ((src, (si, sd)), (tgt, (ti, td))):
            assert (i == I8[f]).all()
            assert (d.view(np.uint32) == (D16[f].astype(np.float32) * scale).view(np.uint32)).all()


def test_the_fleet_round_is_the_cameras_frames(monkeypatch):
    rounds = []
    chunk_entry = drivers.Program.chunk_entry

    def recording(self):
        fn = chunk_entry(self)

        def call(ci, cd, Ii, Dd, scale):
            rounds.append((Ii.clone(), Dd.clone()))
            return fn(ci, cd, Ii, Dd, scale)

        return call

    monkeypatch.setattr(drivers.Program, "chunk_entry", recording)
    rec = small_run("analytic5.fleet", seed=2**36 + 13, keep=True)
    assert rec["correct"], rec["checks"]
    I8, D16 = rec["seq"]
    n = len(rec["chains"][0]["pairs"])
    for k, (Ii, Dd) in enumerate(rounds[-n:]):
        tgt = [int(ch["pairs"][k][1]) for ch in rec["chains"]]
        assert Ii.dtype == torch.uint8 and Dd.dtype == torch.uint16 and Ii.shape[1] == 1
        assert (Ii[:, 0].numpy() == I8[tgt]).all() and (Dd[:, 0].numpy() == D16[tgt]).all()


def test_the_grabber_copies_where_the_device_is_the_host():
    I8 = np.zeros((3, 2, 2), np.uint8)
    grab = fleet.Grabber((I8, I8.astype(np.uint16)), 2, torch.device("cpu"))
    grab.land([0, 1])
    Ii, _ = grab.to(torch.device("cpu"))
    assert Ii.data_ptr() != grab.intensity.data_ptr()
