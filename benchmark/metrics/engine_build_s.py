"""Seconds of the engine's build (host pair scan, tables, transfer), by the
harness's clock around the build call. Layer: engine build."""

UNIT = "s"


def read(rec):
    return rec["engine_build_s"]
