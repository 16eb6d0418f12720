"""Live terminal preview of a render: the headless stand-in for the
reference's GLFW preview window (src/preview.cpp).

Counterpart of ``pathtrace_tpu/tools/watch.py``.  Draws a PNG (the CLI's
``--preview-every`` file) in the terminal with ANSI truecolor
half-blocks, redrawn when the file changes, its size and time on the
title line.

    python -m pathtrace_tpu_torch.cli scenes/cornell.txt --preview-every 16
    python -m pathtrace_tpu_torch.tools.watch $TMPDIR/cornell.preview.png

(the preview is ``<image name>.preview.png`` in the temporary directory,
``tempfile.gettempdir()``: ``$TMPDIR``, else /tmp).  The interactive
camera (src/main.cpp:115-137): give both sides a control file,

    python -m pathtrace_tpu_torch.cli scenes/cornell.txt \\
        --preview-every 16 --interactive /tmp/cam.ctrl
    python -m pathtrace_tpu_torch.tools.watch /tmp/cornell.preview.png \\
        --ctrl /tmp/cam.ctrl

and the arrows orbit, w/a/s/d/r/f move, space saves, esc or q quits.  Each
key appends a line to the file; the renderer reads it between chunks and
restarts the accumulation on a camera key.  Without a terminal (a script,
a test) append the lines with ``render.interact.send_key``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np


def render_ansi(img: np.ndarray, max_cols: int, max_rows: int) -> str:
    """(H,W,3) uint8 -> an ANSI half-block string, two pixel rows a line,
    scaled (nearest) to fit ``max_cols`` x ``max_rows`` cells."""
    h, w, _ = img.shape
    scale = max(w / max_cols, h / (max_rows * 2), 1e-9)
    ow = max(int(w / scale), 1)
    oh = max(int(h / scale) // 2 * 2, 2)
    ys = (np.arange(oh) * (h / oh)).astype(int).clip(0, h - 1)
    xs = (np.arange(ow) * (w / ow)).astype(int).clip(0, w - 1)
    small = img[ys][:, xs]
    top, bot = small[0::2], small[1::2]
    lines = []
    for r in range(top.shape[0]):
        row = []
        for c in range(ow):
            tr, tg, tb = top[r, c]
            br, bg, bb = bot[r, c] if r < bot.shape[0] else (0, 0, 0)
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                       f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


# terminal bytes -> control-file key (the arrows are CSI sequences)
_KEY_SEQS = {
    b"\x1b[A": "up", b"\x1b[B": "down",
    b"\x1b[C": "right", b"\x1b[D": "left",
    b"w": "w", b"a": "a", b"s": "s", b"d": "d",
    b"r": "r", b"f": "f", b" ": "space",
    b"\x1b": "esc", b"q": "q",
}


def _drain_keys(fd) -> list:
    """The keys pending on ``fd`` (a terminal in cbreak mode), read
    without blocking, as control-file key names; a hang-up or an end of
    input gives "q"."""
    import select

    events = []
    buf = b""
    while select.select([fd], [], [], 0)[0]:
        try:
            chunk = os.read(fd, 64)
        except OSError:       # the terminal hung up
            return ["q"]
        if not chunk:         # end of input: quit
            return events + ["q"]
        buf += chunk
    while buf:
        # a CSI sequence first, then one character
        for seq in (buf[:3], buf[:1]):
            if seq in _KEY_SEQS:
                # a lone ESC only if it does not start a CSI sequence
                if seq == b"\x1b" and buf[:2] == b"\x1b[":
                    continue
                events.append(_KEY_SEQS[seq])
                buf = buf[len(seq):]
                break
        else:
            buf = buf[1:]
    return events


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="live render preview (ANSI)")
    p.add_argument("png", help="PNG file to watch (read again on change)")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="draw once and exit")
    p.add_argument("--ctrl", default=None, metavar="FILE",
                   help="read keys from the terminal and append them to "
                        "FILE (with the CLI's --interactive FILE)")
    args = p.parse_args(argv)

    from PIL import Image

    raw = None
    if args.ctrl:
        if not sys.stdin.isatty():
            print("--ctrl needs a tty", file=sys.stderr)
            return 1
        import termios
        import tty

        from ..render.interact import send_key

        fd = sys.stdin.fileno()
        raw = (fd, termios.tcgetattr(fd))
        tty.setcbreak(fd)

    last_mtime = 0.0
    try:
        while True:
            if raw is not None:
                for ev in _drain_keys(raw[0]):
                    send_key(args.ctrl, ev)
                    if ev in ("esc", "q"):
                        return 0
            try:
                mtime = os.path.getmtime(args.png)
            except OSError:
                if args.once:
                    print(f"no such file: {args.png}", file=sys.stderr)
                    return 1
                time.sleep(args.interval)
                continue
            if mtime != last_mtime:
                last_mtime = mtime
                img = np.asarray(Image.open(args.png).convert("RGB"))
                cols, rows = shutil.get_terminal_size()
                out = render_ansi(img, cols, rows - 2)
                sys.stdout.write("\x1b[2J\x1b[H")  # clear, cursor home
                age = time.strftime("%H:%M:%S", time.localtime(mtime))
                print(f"{args.png}  [{img.shape[1]}x{img.shape[0]}, {age}]")
                print(out)
                sys.stdout.flush()
            if args.once:
                return 0
            time.sleep(args.interval if raw is None else 0.05)
    except KeyboardInterrupt:
        return 0
    finally:
        if raw is not None:
            import termios

            termios.tcsetattr(raw[0], termios.TCSADRAIN, raw[1])


if __name__ == "__main__":
    sys.exit(main())
