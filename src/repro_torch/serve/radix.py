"""Radix (trie) prefix cache for the paged serving runtime (a copy of
``repro/serve/radix.py``, which the port does not import).

Maps token prefixes → physical KV-cache blocks so requests sharing a
prefix (the system-prompt case) reuse already-prefilled blocks instead of
re-running prefill. The trie is **block-granular**: each edge is keyed by a
full ``block_size``-token tuple, so a match length is always a multiple of
``block_size`` and a matched block is always *completely* covered by
prompt tokens. That granularity is what lets copy-on-write degenerate to
share-only: a request writes K/V exclusively at positions ``>=`` its
matched length, which land in blocks it allocated privately — shared
blocks are never written (``tests/test_torch_paged.py`` compares a
prefix-cache-hit request's blocks against a cold prefill).

Ownership protocol (the trie holds block *references*, the
``BlockAllocator`` in ``repro_torch.serve.paged`` holds the counts):

* :meth:`insert` walks a finished prompt's full blocks into the trie and
  returns the phys ids of **newly adopted** nodes — the caller takes one
  allocator ref per adopted block on the trie's behalf. Prefixes already
  in the trie keep their existing phys ids (the caller's duplicate blocks
  stay private to the request and die with it).
* :meth:`match` returns the cached phys ids covering the longest cached
  block-aligned prefix — the caller refs each returned block for the
  requesting slot (shared blocks are alive as long as any user remains).
* :meth:`evict` removes the least-recently-used **leaf** whose block the
  caller deems evictable (allocator refcount 1 ⇔ only the trie holds it)
  and returns its phys id for the caller to deref. Internal nodes are
  protected until their children go — eviction peels prefixes from the
  deepest (most specific, least shared) end first.

Pure host-side data structure: no device state.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class _Node:
    """One cached block: ``key`` is its block_size-token tuple (edge label
    from the parent), ``phys`` the physical block index holding its K/V."""
    key: Tuple[int, ...]
    phys: int
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)
    last_use: int = 0


class RadixCache:
    def __init__(self, block_size: int):
        self.block_size = block_size
        self._root = _Node(key=(), phys=-1, parent=None)
        self._clock = 0          # monotonic LRU clock (bumped per touch)
        self._nodes = 0          # cached blocks (root excluded)

    def __len__(self) -> int:
        return self._nodes

    def reset(self) -> None:
        self._root = _Node(key=(), phys=-1, parent=None)
        self._clock = 0
        self._nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _blocks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        n_full = len(tokens) // bs
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n_full)]

    # -- lookup ------------------------------------------------------------

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Phys ids covering the longest cached block-aligned prefix of
        ``tokens`` (possibly empty). Touches the whole matched path's LRU
        clock — a hit protects its prefix chain from eviction."""
        node, phys = self._root, []
        now = self._tick()
        for key in self._blocks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = now
            phys.append(child.phys)
            node = child
        return phys

    # -- insertion ---------------------------------------------------------

    def insert(self, tokens: Sequence[int], phys: Sequence[int]) -> List[int]:
        """Walk ``tokens``' full blocks into the trie; ``phys[i]`` is the
        physical block holding block i's K/V. Returns the phys ids of
        newly created nodes — the caller must take one allocator ref per
        id (the trie's ownership share). Existing nodes keep their phys
        (two requests can cold-prefill the same prefix concurrently; first
        insert wins, the loser's blocks stay private)."""
        node = self._root
        adopted: List[int] = []
        now = self._tick()
        for key, p in zip(self._blocks(tokens), phys):
            child = node.children.get(key)
            if child is None:
                child = _Node(key=key, phys=int(p), parent=node)
                node.children[key] = child
                self._nodes += 1
                adopted.append(int(p))
            child.last_use = now
            node = child
        return adopted

    # -- eviction ----------------------------------------------------------

    def evict(self, evictable: Callable[[int], bool]) -> Optional[int]:
        """Remove the LRU leaf whose phys block passes ``evictable`` and
        return its phys id (the caller derefs it); None when nothing
        qualifies. Leaf-only: a node with children pins a live prefix."""
        best: Optional[_Node] = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.children:
                continue
            if not evictable(node.phys):
                continue
            if best is None or node.last_use < best.last_use:
                best = node
        if best is None:
            return None
        del best.parent.children[best.key]
        self._nodes -= 1
        return best.phys

    def cached_blocks(self) -> List[int]:
        """Every phys id currently held by the trie (tests/debugging)."""
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self._root:
                out.append(node.phys)
        return out
