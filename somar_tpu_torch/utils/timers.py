"""Hierarchical wall-clock timers (PyTorch port of
`somar_tpu.utils.timers`): nested `with timer("name")` scopes accumulate
wall-clock time and call counts; `report()` prints the tree.  Device work
is asynchronous, so a scope that should include the device time of its
work passes `block=` a tensor of that work: on a CUDA tensor the scope
synchronizes its device before it stops the clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


class _Node:
    __slots__ = ("name", "total", "calls", "children")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.calls = 0
        self.children: Dict[str, "_Node"] = {}


class TimerRegistry:
    def __init__(self):
        self.root = _Node("total")
        self._stack: List[_Node] = [self.root]

    @contextlib.contextmanager
    def __call__(self, name: str, block=None):
        parent = self._stack[-1]
        node = parent.children.setdefault(name, _Node(name))
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if isinstance(block, torch.Tensor) and block.is_cuda:
                torch.cuda.synchronize(block.device)
            node.total += time.perf_counter() - t0
            node.calls += 1
            self._stack.pop()

    def report(self, file=None) -> str:
        lines = ["--- timer report ---"]

        def walk(node: _Node, depth: int):
            for child in node.children.values():
                lines.append(f"{'  ' * depth}{child.name}: "
                             f"{child.total:.3f}s  ({child.calls} calls)")
                walk(child, depth + 1)

        walk(self.root, 0)
        text = "\n".join(lines)
        if file is not None:
            print(text, file=file)
        return text

    def reset(self):
        self.root = _Node("total")
        self._stack = [self.root]


#: the process-wide registry
timer = TimerRegistry()
