"""system.dispatch_ms.offline: the host's mean ms in System.dispatch_chunk
over the window's chunks (the chunk API's enqueue of a chunk's frames,
with the one host read a tracked frame makes)."""


def read(run):
    ms = run.in_window("system.dispatch_chunk")
    return sum(ms) / len(ms) if ms else None
