"""Workload limits: active-series quotas applied at ingest
(:mod:`.quota`) and end-to-end query deadlines (:mod:`.deadline`)."""

from filodb_tpu_torch.query.model import QueryError


class AdmissionRejected(QueryError):
    """Shed by an admission controller: the caller yields and retries
    later (the rollup engine requeues its tick's work)."""

    def __init__(self, query_id: str, message: str, reason: str = "",
                 retry_after_s: float = 1.0):
        super().__init__(query_id, message)
        self.reason = reason
        self.retry_after_s = max(float(retry_after_s), 1.0)
