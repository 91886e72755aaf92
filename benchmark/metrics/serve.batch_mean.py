"""Requests per pipeline call the server formed in the steady part of the
window (the recording proxy in the pipeline's place counts them)."""


def read(r):
    calls = r["steady_calls"]
    return sum(len(c["ids"]) for c in calls) / len(calls) if calls else None
