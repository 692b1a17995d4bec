"""Query planning: LogicalPlan -> ExecPlan."""
