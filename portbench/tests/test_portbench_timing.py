"""The window, rate and spread arithmetic on made-up timings."""

import statistics

import pytest

from portbench import timing


def test_rate_over_window_counts_the_whole_window():
    # jobs end at 1.0, 2.5 and 4.0 s after a window that opened at 10.0
    assert timing.rate_over_window(10.0, [11.0, 12.5, 14.0]) == \
        pytest.approx(4.0 / 3)
    with pytest.raises(ValueError):
        timing.rate_over_window(0.0, [])


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert timing.spread(xs) == pytest.approx((q3 - q1) / 3.5)
    assert timing.spread([2.0] * 6) == 0.0


def test_profile_summary_unions_activity_and_names_gaps():
    from portbench import probe
    spans = probe.Spans()
    spans.records += [("job", 0, 100), ("evaluate", 10, 40),
                      ("escalation", 60, 90)]
    events = [("k2", 12, 20), ("copy", 15, 25), ("k2", 30, 35),
              ("k1", 95, 130)]
    p = probe.profile_summary(events, 0, 100, spans)
    # busy: [12, 25) + [30, 35) + [95, 100) = 23 ns, clipped to the window
    assert p["busy_s"] == pytest.approx(23e-9)
    assert p["window_s"] == pytest.approx(100e-9)
    # each gap goes to the innermost span around its middle
    gaps = dict(p["idle_gaps"])
    assert gaps == pytest.approx({"job": 12e-9,          # [0, 12)
                                  "evaluate": 5e-9,      # [25, 30)
                                  "escalation": 60e-9})  # [35, 95)
    assert dict(p["device_ops"])["k2"] == pytest.approx(13e-9)


def test_roofline_bound_takes_the_larger_term():
    from portbench import roofline
    t, by = roofline.bound_s(n_bytes=3_350_000, iters=0, e_pad=1024)
    assert by == "bytes" and t == pytest.approx(1e-6)
    t, by = roofline.bound_s(n_bytes=0, iters=1000, e_pad=67_000 // 6,
                             cert_slots=0)
    assert by == "operations"
    assert t == pytest.approx(1000 * (67_000 // 6) * 6 / 67e12)
    assert roofline.share_percent(1.0, 4.0) == 25.0
    assert roofline.share_percent(1.0, 0.0) is None


def test_spread_cli_reads_result_lines(tmp_path, capsys):
    import json

    from portbench import spread as cli
    paths = []
    for i, v in enumerate([1.0, 2.0, 3.0, 4.0]):
        p = tmp_path / f"run{i}.out"
        p.write_text("noise\n" + json.dumps(
            {"metrics": {"job_s": {"value": v, "unit": "s"}}}) + "\n")
        paths.append(str(p))
    assert cli.main(paths) == 0
    got = json.loads(capsys.readouterr().out.strip())
    assert got["median"] == 2.5
    assert got["spread"] == pytest.approx(timing.spread([1.0, 2.0, 3.0,
                                                         4.0]))
