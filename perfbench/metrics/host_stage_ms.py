"""host_stage_ms: host milliseconds to plan, pack and upload a mega-batch
(``ElasticTrainer.staging_log``), the mean over the window."""


def read(run):
    if not run.staging:
        return None
    return 1e3 * sum(e["plan_s"] + e["pack_s"] + e["upload_s"] for e in run.staging) \
        / len(run.staging)
