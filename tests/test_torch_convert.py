"""The port's converters (`geomesa_tpu_torch.convert`) against the
reference's on the same inputs: every converter type (delimited CSV and
TSV, JSON, fixed-width, XML, shapefile, Parquet, JDBC over sqlite3, the
gated Avro) and the well-known configs give equal batches (feature ids,
values, failure counts) in both error modes, and the transform language
evaluates every function, cast and error case to the same value.
"""

import io
import json
import sqlite3

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from geomesa_tpu import convert as rconv
from geomesa_tpu.convert import formats as rformats
from geomesa_tpu.convert import schemas as rschemas
from geomesa_tpu.core.sft import SimpleFeatureType as RSFT
from geomesa_tpu_torch import convert as pconv
from geomesa_tpu_torch.convert import formats as pformats
from geomesa_tpu_torch.convert import schemas as pschemas
from geomesa_tpu_torch.core.columnar import DictColumn, FeatureBatch, GeometryColumn
from geomesa_tpu_torch.core.sft import SimpleFeatureType as PSFT

PKG = {"ref": (rconv, RSFT, rschemas, rformats),
       "port": (pconv, PSFT, pschemas, pformats)}


def doc(batch, failed):
    """A batch as plain values: fids, each column (dictionary columns
    decoded, points as x/y, other geometries as WKT) and the failures."""
    out = {"n": len(batch), "failed": failed,
           "fids": None if batch.fids is None
           else [batch.fids.vocab[c] for c in batch.fids.codes]}
    for name, col in batch.columns.items():
        if hasattr(col, "vocab"):
            out[name] = [None if c < 0 else col.vocab[c] for c in col.codes]
        elif hasattr(col, "is_point"):
            out[name] = (np.asarray(col.x).tolist(), np.asarray(col.y).tolist()) \
                if col.is_point else [str(col.geometry(i)) for i in range(len(col))]
        else:
            a = np.asarray(col)
            out[name] = [None if isinstance(v, float) and v != v else v
                         for v in a.tolist()]
    return out


def convert_both(spec, config, source, error_mode=None):
    """Each package's converter over `source` (a string, or a callable
    giving the source for a package's formats module): its batch as
    `doc`, or the type of the exception it raised."""
    out = {}
    for name, (conv, sft_cls, _, formats) in PKG.items():
        cfg = json.loads(json.dumps(config))
        if error_mode:
            cfg.setdefault("options", {})["error-mode"] = error_mode
        src = source(formats) if callable(source) else source
        try:
            c = conv.converter_from_config(sft_cls.from_spec("t", spec), cfg)
            b = c.convert(io.StringIO(src) if isinstance(src, str)
                          and "\n" in src else src)
            out[name] = doc(b, c.failed)
        except Exception as e:  # noqa: BLE001 — the type must match
            out[name] = type(e).__name__
    return out


CSV = """id,name,lat,lon,when
1,alpha,51.5,-0.1,2020-06-01T00:00:00Z
2,beta,48.8,2.35,2020-06-02T00:00:00Z
3,,48.8,2.35,2020-06-03T00:00:00Z
bad,gamma,not_a_lat,xx,2020-06-04T00:00:00Z
4,"quoted, name",10,20,2020-06-05T00:00:00Z
"""
XML = """<doc>
  <row id="a"><props><name>alpha</name></props><lon>2.35</lon><lat>48.85</lat></row>
  <row id="b"><props><name>beta</name></props><lon>-90.1</lon><lat>29.9</lat></row>
  <row id="c"><props><name>gamma</name></props><lon>oops</lon><lat>1</lat></row>
</doc>"""


def json_lines():
    recs = [{"props": {"name": f"n{i}"}, "when": f"2020-06-0{i + 1}T00:00:00Z",
             "loc": [i * 1.5, i * -2.0]} for i in range(5)]
    recs.append({"props": {}, "when": "2020-06-09T00:00:00Z"})  # no point
    recs.append({"props": {"name": "x"}, "when": "nope", "loc": [1, 2]})
    return "\n".join(json.dumps(r) for r in recs) + "\n"


def shapefile(path):
    def make(formats):
        sft_cls = PSFT if formats is pformats else RSFT
        fb_mod = __import__(formats.__name__.rsplit(".", 2)[0] + ".core.columnar",
                            fromlist=["FeatureBatch"])
        sft = sft_cls.from_spec("s", "name:String,score:Double,*geom:Point")
        p = f"{path}_{'p' if formats is pformats else 'r'}.shp"
        formats.write_shapefile(p, fb_mod.FeatureBatch.from_pydict(sft, {
            "name": ["alpha", "beta", "gamma"], "score": [1.5, -2.25, 1e20],
            "geom": np.array([[2.35, 48.85], [-90.1, 29.9], [0.0, 0.0]])}))
        return p
    return make


CASES = {
    "csv": ("name:String,dtg:Date,*geom:Point", {
        "type": "delimited-text", "format": "CSV",
        "options": {"skip-lines": 1}, "id-field": "$1",
        "fields": [{"name": "name", "transform": "withDefault($2, 'unknown')"},
                   {"name": "dtg", "transform": "isoDateTime($5)"},
                   {"name": "geom", "transform": "point($4, $3)"}]}, CSV),
    "csv_no_id_misaligned": ("name:String,*geom:Point", {
        "type": "delimited-text",
        "fields": [{"name": "name", "transform": "$1"},
                   {"name": "geom", "transform": "point($2, $3)"}]},
        "a,1,2\nbad,,\nc,5,6\n"),
    "json": ("name:String,dtg:Date,*geom:Point", {
        "type": "json", "id-field": "$name",
        "fields": [{"name": "name", "path": "$.props.name",
                    "transform": "withDefault($0, 'UNKNOWN')"},
                   {"name": "dtg", "path": "$.when",
                    "transform": "isoDateTime($0)"},
                   {"name": "lon", "path": "$.loc.0"},
                   {"name": "lat", "path": "$.loc.1"},
                   {"name": "geom", "transform": "point($lon, $lat)"}]},
        json_lines()),
    "fixed_width": ("name:String,*geom:Point", {
        "type": "fixed-width", "options": {"skip-lines": 1},
        "fields": [{"name": "name", "start": 0, "width": 5},
                   {"name": "lat", "start": 5, "width": 6,
                    "transform": "$0::double"},
                   {"name": "lon", "start": 11, "width": 7,
                    "transform": "$0::double"},
                   {"name": "geom", "transform": "point($lon, $lat)"}]},
        "HEADER\nalpha 48.85   2.35\nbeta  29.90 -90.10\ngamma xx.xx   1.00\n"),
    "xml": ("rid:String,name:String,*geom:Point", {
        "type": "xml", "feature-path": "doc/row", "id-field": "$rid",
        "fields": [{"name": "rid", "path": "@id"},
                   {"name": "name", "path": "props/nope",
                    "transform": "withDefault($0, 'UNK')"},
                   {"name": "lon", "path": "lon", "transform": "$0::double"},
                   {"name": "lat", "path": "lat", "transform": "$0::double"},
                   {"name": "geom", "transform": "point($lon, $lat)"}]}, XML),
    "avro": ("*geom:Point", {"type": "avro"}, "x\n"),
}


@pytest.mark.parametrize("mode", ["skip-bad-records", "raise-errors"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_converter_batches_match_the_reference(case, mode):
    spec, config, source = CASES[case]
    out = convert_both(spec, config, source, mode)
    assert out["port"] == out["ref"]
    if case != "avro" and mode == "skip-bad-records":
        assert out["port"]["n"] > 0 and out["port"]["failed"] >= 1
    if case == "avro":
        assert out["port"] == "ImportError"


@pytest.mark.parametrize("mode", ["skip-bad-records", "raise-errors"])
def test_shapefile_parquet_and_jdbc_inputs_match(tmp_path, mode):
    sh = convert_both("name:String,score:Double,*geom:Point", {"type": "shp"},
                      shapefile(str(tmp_path / "pts")), mode)
    assert sh["port"] == sh["ref"] and sh["port"]["n"] == 3
    p = str(tmp_path / "in.parquet")
    pq.write_table(pa.table({"name": ["a", "b", "c", "d"],
                             "score": [1.5, 2.5, None, 4.0],
                             "lon": [10.0, 20.0, 30.0, None],
                             "lat": [1.0, 2.0, 3.0, 4.0]}), p)
    par = convert_both("name:String,score:Double,*geom:Point", {
        "type": "parquet", "id-field": "$name",
        "fields": [{"name": "name", "path": "name"},
                   {"name": "score", "path": "score"},
                   {"name": "geom", "transform": "point($lon, $lat)"}]},
        p, mode)
    assert par["port"] == par["ref"]
    db = str(tmp_path / "obs.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE obs (id TEXT, lon REAL, lat REAL, v REAL)")
    conn.executemany("INSERT INTO obs VALUES (?, ?, ?, ?)",
                     [("o1", 1.0, 2.0, 7.5), ("o2", 3.0, 4.0, 8.5),
                      ("o3", None, 4.0, 9.5)])
    conn.commit()
    conn.close()
    jd = convert_both("v:Double,*geom:Point", {
        "type": "jdbc", "query": "SELECT id, lon, lat, v FROM obs ORDER BY id",
        "id-field": "$id",
        "fields": [{"name": "v", "path": "v"},
                   {"name": "geom", "transform": "point($lon, $lat)"}]},
        db, mode)
    assert jd["port"] == jd["ref"]


def gdelt_line(i):
    cols = [""] * 57
    cols[0], cols[1] = f"e{i}", f"202006{i % 28 + 1:02d}"
    cols[6] = ["FRANCE", "", "USA"][i % 3]
    cols[16] = ["", "GOV"][i % 2]
    cols[26], cols[30], cols[31] = f"{i % 200:03d}", f"{i * 0.7 - 9:.1f}", \
        ["12", "x", ""][i % 3]
    cols[53], cols[54] = f"{(i * 7.3) % 180 - 90:.4f}", f"{(i * 13.1) % 360 - 180:.4f}"
    if i == 5:
        cols[53] = "bad"
    return "\t".join(cols)


WELL_KNOWN = {
    "gdelt": "\n".join(gdelt_line(i) for i in range(40)) + "\n",
    "ais": ("MMSI,BaseDateTime,LAT,LON,SOG,COG,Heading,VesselName\n"
            "367000001,2021-03-01T00:00:01,29.9,-90.1,7.5,180.0,181.0,EVER GIVEN\n"
            "367000002,2021-03-01T00:00:02,30.0,-90.0,,,,\n"
            "367000003,not-a-date,30.0,-90.0,1,2,3,X\n"),
    "osm": ("42,2.35,48.85,mapper,3,2021-05-01T12:00:00,amenity=cafe\n"
            "43,2.36,48.86,,x,2021-05-01T12:00:01,\n"),
    "twitter": "\n".join(json.dumps(t) for t in (
        {"id_str": "123", "text": "hello", "user": {"screen_name": "alice"},
         "created_at": "Wed Aug 27 13:08:45 +0000 2008",
         "coordinates": {"type": "Point", "coordinates": [-74.0, 40.7]}},
        {"id_str": "124", "created_at": "Wed Aug 27 13:08:46 +0000 2008",
         "coordinates": None})) + "\n",
}


@pytest.mark.parametrize("mode", ["skip-bad-records", "raise-errors"])
@pytest.mark.parametrize("name", sorted(WELL_KNOWN))
def test_well_known_configs_match(name, mode):
    out = {}
    for pkg, (conv, _, schemas, _) in PKG.items():
        sft, config = schemas.WELL_KNOWN[name]
        cfg = json.loads(json.dumps(config))
        cfg.setdefault("options", {})["error-mode"] = mode
        c = conv.converter_from_config(sft, cfg)
        try:
            out[pkg] = doc(c.convert(io.StringIO(WELL_KNOWN[name])), c.failed)
        except Exception as e:  # noqa: BLE001 — the type must match
            out[pkg] = type(e).__name__
    assert out["port"] == out["ref"]
    assert pschemas.GDELT_SPEC == rschemas.GDELT_SPEC
    assert pschemas.GDELT_CONVERTER == rschemas.GDELT_CONVERTER


TRANSFORMS = {
    "refs_and_casts": [("$1::int", ["x", "42"]), ("$2::double", ["x", "1", "2.5"]),
                       ("$name", []), ("$1::long", ["", "7.0"]),
                       ("$1::boolean", ["", "Yes"]), ("$1::string", ["", 3]),
                       ("$1::float", ["", "1e3"]), ("$1::integer", ["", "-4"])],
    "strings": [("concat($1, '-', $2)", ["", "a", "b"]),
                ("lowercase(trim($1))", ["", "  AB "]),
                ("strip($1, 'x')", ["", "xxAxx"]),
                ("uppercase($1)", ["", "ab"]),
                ("substring($1, 1, 3)", ["", "abcdef"]),
                ("replace($1, 'a', 'b')", ["", "banana"]),
                ("regexReplace('[0-9]+', '#', $1)", ["", "a1b22"]),
                ("length($1)", ["", "four"]),
                ("concat(uppercase($1), toString(toInt($2)))", ["", "ab", "9"]),
                ("'it''s'", [])],
    "hashes": [("md5($1)", ["", "v"]), ("murmurHash3($1)", ["", "v"])],
    "numbers": [("toInt($1, 7)", ["", "bad"]), ("toInt($1)", ["", "12"]),
                ("toLong($1, 0)", ["", ""]), ("toDouble($1, 0.5)", ["", "x"]),
                ("toFloat($1)", ["", "2.25"]), ("stringToInt($1, 1)", ["", "3"]),
                ("stringToDouble($1, 1)", ["", "z"]), ("toBoolean($1)", ["", "t"]),
                ("toString($1)", ["", 1.5]), ("-3.5", []), ("12", [])],
    "defaults": [("withDefault($1, 'x')", ["", ""]),
                 ("withDefault($1, 'x')", ["", "y"]),
                 ("require($1)", ["", "v"]), ("require($1)", ["", ""]),
                 ("lineNo()", [""])],
    "geometry": [("point($1, $2)", ["", "1.5", "2.5"]),
                 ("point($1, $2)", ["", "", "2"]),
                 ("geometry($1)", ["", "POINT (1 2)"]),
                 ("geometry($1)", ["", "LINESTRING (0 0, 1 1, 2 0)"]),
                 ("geometry($1)", ["", "NOT WKT"])],
    "dates": [("dateParse('yyyyMMdd', $1)", ["", "20200601"]),
              ("date('yyyy-MM-dd HH:mm:ss', $1)", ["", "2020-06-01 12:30:05"]),
              ("dateParse('EEE MMM dd HH:mm:ss Z yyyy', $1)",
               ["", "Wed Aug 27 13:08:45 +0000 2008"]),
              ("dateParse('yyyy-MM-dd''T''HH:mm:ss.SSS''Z''', $1)",
               ["", "2020-06-01T01:02:03.456Z"]),
              ("dateParse('yyyyDDD', $1)", ["", "2020153"]),
              ("isoDate($1)", ["", "2020-06-01"]),
              ("isoDateTime($1)", ["", "2020-06-01T12:00:00Z"]),
              ("isoDateTime($1)", ["", "2020-06-01T12:00:00.250+02:00"]),
              ("secsToDate($1)", ["", "100"]), ("millisToDate($1)", ["", "5"]),
              ("dateParse('yyyyMMdd', $1)", ["", "junk"])],
    "compile_errors": [("nosuchfn($1)", None), ("$1::nosuchtype", None),
                       ("toInt(", None), ("concat($1,", None)],
}


def evaluate(conv, expr, pos):
    try:
        fn = conv.compile_expression(expr)
    except Exception as e:  # noqa: BLE001 — compile errors must match
        return ("compile", type(e).__name__)
    if pos is None:
        return ("compiled",)
    try:
        v = fn(conv.EvalContext(list(pos), {"named": "n"}, line_no=3))
    except Exception as e:  # noqa: BLE001 — evaluation errors must match
        return ("eval", type(e).__name__)
    return ("value", repr(v) if not isinstance(v, float) else v)


@pytest.mark.parametrize("group", sorted(TRANSFORMS))
def test_transform_language_matches(group):
    for expr, pos in TRANSFORMS[group]:
        assert evaluate(pconv, expr, pos) == evaluate(rconv, expr, pos), expr


def test_uuid_is_a_fresh_uuid_in_both():
    for conv in (pconv, rconv):
        fn = conv.compile_expression("uuid()")
        a, b = (fn(conv.EvalContext([""], {})) for _ in range(2))
        assert len(a) == 36 and a.count("-") == 4 and a != b


def test_batch_columns_are_the_ports_own_types():
    c = pconv.converter_from_config(*pschemas.WELL_KNOWN["gdelt"])
    b = c.convert(io.StringIO(WELL_KNOWN["gdelt"]))
    assert isinstance(b, FeatureBatch)
    assert isinstance(b.columns["geom"], GeometryColumn)
    assert isinstance(b.columns["Actor1Name"], DictColumn)
