import numpy as np

from postgres_word2vec.utils import codec


def test_codec_roundtrips(rng):
    v = rng.normal(size=(17,)).astype(np.float32)
    np.testing.assert_array_equal(codec.bytes_to_float4(
        codec.vec_to_bytes(v, "float4")), v)
    iv = rng.integers(-1000, 1000, size=(9,)).astype(np.int32)
    np.testing.assert_array_equal(codec.bytes_to_int4(
        codec.vec_to_bytes(iv, "int4")), iv)
    sv = rng.integers(0, 256, size=(12,)).astype(np.int16)
    np.testing.assert_array_equal(codec.bytes_to_int2(
        codec.vec_to_bytes(sv, "int2")), sv)


def test_codec_little_endian_layout():
    # 1.0f little-endian = 00 00 80 3f — the exact byte layout the
    # reference's read_bytea_float expects
    assert codec.vec_to_bytes([1.0], "float4") == b"\x00\x00\x80\x3f"
    assert codec.vec_to_bytes([1], "int2") == b"\x01\x00"


def test_codec_column_roundtrip(rng):
    arr = rng.integers(0, 255, size=(5, 12)).astype(np.int16)
    blobs = codec.encode_vector_column(arr, "int2")
    back = codec.decode_vector_column(blobs, "int2")
    np.testing.assert_array_equal(back, arr)


def test_confidence_bin_matches_scipy():
    from scipy import stats as sps
    from postgres_word2vec.models.ivpq import confidence_bin
    mu = 200 * 0.1
    sig = np.sqrt(200 * 0.1 * 0.9)
    want = 1.0 - sps.norm.cdf((15 - 0.5 - mu) / sig)
    got = float(confidence_bin(15, 200, 0.1))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_plots_render(tmp_path):
    from postgres_word2vec.evaluation import plots
    records = [
        {"method": 0, "alpha": 50, "time_s": 1.0, "precision": 0.4},
        {"method": 0, "alpha": 100, "time_s": 2.0, "precision": 0.6},
        {"method": 1, "alpha": 50, "time_s": 3.0, "precision": 1.0},
    ]
    out = plots.plot_time_precision(records, tmp_path / "tp.png")
    assert out.exists() and out.stat().st_size > 1000
    out2 = plots.plot_stage_breakdown(
        [{"queries": 5, "inner_s": 1.0, "interface_overhead_s": 0.5},
         {"queries": 20, "inner_s": 2.0, "interface_overhead_s": 0.6}],
        tmp_path / "stage.png")
    assert out2.exists()
    out3 = plots.plot_measurement_bars({"exact": 1.0, "pq": 0.2},
                                       tmp_path / "bars.png")
    assert out3.exists()


def test_html_report_structure(tmp_path):
    """Self-contained interactive report: embedded JSON payload, one host
    div per figure, escaped titles, series capped at the validated
    palette, no external resources."""
    import json as _json

    from postgres_word2vec.evaluation.html_report import (
        Figure, Series, figure_from_records, write_html_report)

    recs = [{"method": 0, "alpha": 50, "pvf": 10, "time_s": 0.05,
             "precision": 0.6},
            {"method": 0, "alpha": 100, "pvf": 10, "time_s": 0.08,
             "precision": 0.8},
            {"method": 2, "alpha": 50, "pvf": 10, "time_s": 0.07,
             "precision": 0.9}]
    fig = figure_from_records(recs)
    assert len(fig.series) == 2
    f2 = Figure(title="<qps> & targets", xlabel="targets", ylabel="QPS",
                xlog=True,
                series=[Series("exact", [1e5, 1e6], [24000, 9900])])
    out = write_html_report(tmp_path / "r.html", [fig, f2],
                            title="demo <title>", subtitle="sub")
    html = out.read_text()
    # titles are escaped in the markup (the JSON payload may carry raw
    # text — it is data, inserted via textContent, with "</" escaped)
    assert "demo &lt;title&gt;" in html
    assert "&lt;qps&gt; &amp; targets" in html
    assert "<h2><qps>" not in html
    assert "fig-0" in html and "fig-1" in html
    # embedded payload parses and round-trips the series
    payload = html.split("id='viz-data'>")[1].split("</script>")[0]
    data = _json.loads(payload.replace("<\\/", "</"))
    assert len(data["figures"]) == 2
    assert data["figures"][1]["xlog"] is True
    assert data["figures"][0]["series"][0]["light"].startswith("#")
    # self-contained: no external scripts/styles/CDN fetches (the SVG
    # namespace URI inside createElementNS is an identifier, not a fetch)
    assert "<script src" not in html and "<link" not in html
    assert "cdn" not in html.lower()
    # series cap enforced
    import pytest
    with pytest.raises(ValueError, match="palette"):
        Figure(title="t", xlabel="x", ylabel="y",
               series=[Series(f"s{i}", [0], [0]) for i in range(9)]
               ).to_json()
