"""Facts about aten operators that more than one layer reads."""

__all__ = ["UNINITIALIZED_OPS"]

#: ops whose outputs hold no values yet (a later op writes them in place):
#: a replay's digest and a counted card's bytes leave them out
UNINITIALIZED_OPS = frozenset(f"aten::{n}" for n in (
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"))
