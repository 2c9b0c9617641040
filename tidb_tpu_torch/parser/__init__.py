from tidb_tpu_torch.parser.sqlparse import parse, parse_expr, parse_tokens, ParseError  # noqa: F401
from tidb_tpu_torch.parser import ast  # noqa: F401
