from pilosa_tpu_torch.pql.ast import Call, Condition, Query  # noqa: F401
from pilosa_tpu_torch.pql.parser import ParseError, parse  # noqa: F401
