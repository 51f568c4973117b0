"""Filter framework ABI and backends (the port's ``xla`` backend)."""

from .framework import (Accelerator, FilterError, FilterFramework,
                        FilterProperties, find_filter, list_filters,
                        register_filter)
from .single import FilterSingle

__all__ = ["Accelerator", "FilterError", "FilterFramework",
           "FilterProperties", "FilterSingle", "find_filter",
           "list_filters", "register_filter"]
