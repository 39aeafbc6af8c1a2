"""CQL/ECQL filter engine of the port.

The parser, AST and bounds extraction are copies of the reference
package's `cql/` modules; `compile` lowers the AST to a mask over torch
tensors on the store's device, and `hosteval` is its f64 NumPy
counterpart for rows inside the f32 boundary band.
"""

from geomesa_tpu_torch.cql.parser import parse_cql
from geomesa_tpu_torch.cql.extract import extract_bbox, extract_intervals
from geomesa_tpu_torch.cql.compile import compile_filter, CompiledFilter

__all__ = [
    "parse_cql",
    "extract_bbox",
    "extract_intervals",
    "compile_filter",
    "CompiledFilter",
]
