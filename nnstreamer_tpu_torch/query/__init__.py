"""Query serving plane.  Only the overload controls the LLM slot pool
admits through are ported so far (ROADMAP A9)."""
