"""Process lifetime: no process that a run starts outlives the run. Before
it prints its result, a run looks up its live children under ``/proc``
(``children``); where it finds one it kills and reaps it
(``kill_children``) and exits as failed.
"""

from __future__ import annotations

import os
import signal


def children(pid: int | None = None) -> list[int]:
    """The pids of the live (not zombie) children of ``pid`` (default:
    this process)."""
    pid = os.getpid() if pid is None else pid
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the command name is in parentheses and may hold spaces
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(entry))
    return out


def kill_children() -> list[int]:
    """SIGKILL every live child of this process and reap it; returns the
    pids it found."""
    found = children()
    for pid in found:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in found:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
    return found
