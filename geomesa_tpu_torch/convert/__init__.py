"""Converter framework: config-driven ingest.

A copy of the reference package's `convert/`: the same configs, the same
transform language and the same batches (fids, values, failure counts).
Converters run per record in Python on the host; the card sees only the
columnar batch they produce. Modelled on geomesa-convert (SimpleFeatureConverter SPI v2, o.l.g.convert2)
[upstream, unverified]: TypeSafe-Config-defined field extraction plus a
transform expression DSL ($1, dateParse(...), point($lon,$lat), md5(...),
uuid(), casts) over delimited text / JSON sources; predefined well-known
schemas (GDELT, AIS, NYC taxi) as geomesa-tools ships.
"""

from geomesa_tpu_torch.convert.transforms import compile_expression, EvalContext
from geomesa_tpu_torch.convert.converter import (
    DelimitedTextConverter,
    JsonConverter,
    converter_from_config,
)
from geomesa_tpu_torch.convert import schemas

__all__ = [
    "compile_expression",
    "EvalContext",
    "DelimitedTextConverter",
    "JsonConverter",
    "converter_from_config",
    "schemas",
]
