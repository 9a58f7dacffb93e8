"""``--open``: open the image with the platform viewer (src/lib.rs:346-365)."""

from __future__ import annotations

import shlex
import subprocess
import sys


def open_in_viewer(path: str) -> None:
    if sys.platform.startswith("win"):
        cmd = ["cmd", "/C", f"start {path}"]
    elif sys.platform == "darwin":
        cmd = ["sh", "-c", f"open {shlex.quote(path)}"]
    else:
        cmd = ["sh", "-c", f"xdg-open {shlex.quote(path)}"]
    try:
        subprocess.Popen(cmd)
    except OSError as e:
        print(f"failed to open image: {e}", file=sys.stderr)
