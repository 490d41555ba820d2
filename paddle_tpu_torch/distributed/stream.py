"""paddle.distributed.stream — stream-variant collectives, after
``paddle_tpu/distributed/stream.py``.

Reference: python/paddle/distributed/communication/stream/* — the
``use_calc_stream`` forms that skip the comm-stream hop. The port's
collectives run on gloo in the calling thread (``collective.py``), with
no stream of their own, so every stream variant is the base op with the
sync knobs accepted for API parity.

Flight-recorder visibility: every stream call records a ring entry of its
own — kind ``stream.<op>``, tagged with the ``sync_op`` /
``use_calc_stream`` knobs — on top of the base op's entry, so a
post-mortem shows which surface issued the op. With ``sync_op=False`` the
entry stays *issued* and a task handle is returned; the entry completes
at ``wait()``, so an async stream collective a rank never waited on shows
up as pending in its dump.
"""
from __future__ import annotations

from . import collective as _c
from . import comm_extra as _cx
from . import flight_recorder as _fr

__all__ = ["all_gather", "all_reduce", "alltoall", "alltoall_single",
           "broadcast", "gather", "recv", "reduce", "reduce_scatter",
           "scatter", "send"]


class _StreamTask:
    """Handle for a ``sync_op=False`` stream collective: ``wait()`` stamps
    the entry's ``t_wait``, completes the ring entry and returns the
    result (the op itself has already run: gloo runs it in the calling
    thread)."""

    def __init__(self, result, entry):
        self._result = result
        self._entry = entry
        self._done = False

    def wait(self):
        if not self._done:
            self._done = True
            _fr.note_wait_begin(self._entry)
            _fr.record_complete(self._entry)
        return self._result

    def is_completed(self):
        return self._done


def _run(kind, fn, tensor, group, sync_op, use_calc_stream, p2p=False):
    if _fr.get_recorder() is None:
        # disabled path stays a plain delegation (no group resolution)
        out = fn()
        return out if sync_op else _StreamTask(out, None)
    if p2p:
        gname = "p2p"  # matches comm_extra's p2p entries
    else:
        g = _c._as_group(group)  # same resolution the base op does
        gname = f"{g.axis}:{g.id}"
    e = _fr.record_issue(
        f"stream.{kind}", group=gname,
        shape=tuple(tensor.shape) if tensor is not None else None,
        dtype=tensor.dtype if tensor is not None else None,
        extra={"sync_op": bool(sync_op),
               "use_calc_stream": bool(use_calc_stream),
               "nbytes": tensor.numel() * tensor.element_size()
               if tensor is not None else 0})
    try:
        out = fn()
    except BaseException:
        # close the entry, or a raised op reads as a stalled collective
        # in a later blame pass
        _fr.record_complete(e)
        if e is not None:
            e["status"] = "error"
        raise
    if sync_op:
        _fr.record_complete(e)
        return out
    return _StreamTask(out, e)


def all_gather(tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    return _run("all_gather",
                lambda: _c.all_gather(tensor_list, tensor, group=group,
                                      sync_op=sync_op),
                tensor, group, sync_op, use_calc_stream)


def all_reduce(tensor, op=_c.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _run("all_reduce",
                lambda: _c.all_reduce(tensor, op=op, group=group,
                                      sync_op=sync_op),
                tensor, group, sync_op, use_calc_stream)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _run("broadcast",
                lambda: _c.broadcast(tensor, src=src, group=group,
                                     sync_op=sync_op),
                tensor, group, sync_op, use_calc_stream)


def reduce(tensor, dst=0, op=_c.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _run("reduce",
                lambda: _c.reduce(tensor, dst=dst, op=op, group=group,
                                  sync_op=sync_op),
                tensor, group, sync_op, use_calc_stream)


def reduce_scatter(tensor, tensor_or_tensor_list, op=_c.ReduceOp.SUM,
                   group=None, sync_op=True, use_calc_stream=False):
    return _run("reduce_scatter",
                lambda: _c.reduce_scatter(tensor, tensor_or_tensor_list,
                                          op=op, group=group,
                                          sync_op=sync_op),
                tensor, group, sync_op, use_calc_stream)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True,
            use_calc_stream=False):
    return _run("scatter",
                lambda: _c.scatter(tensor, tensor_list=tensor_list,
                                   src=src, group=group, sync_op=sync_op),
                tensor, group, sync_op, use_calc_stream)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    t0 = in_tensor_list[0] if isinstance(in_tensor_list, (list, tuple)) \
        and in_tensor_list else in_tensor_list
    return _run("alltoall",
                lambda: _cx.alltoall(out_tensor_list, in_tensor_list,
                                     group=group, sync_op=sync_op),
                t0, group, sync_op, use_calc_stream)


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    return _run("alltoall_single",
                lambda: _cx.alltoall_single(
                    out_tensor, in_tensor, in_split_sizes=in_split_sizes,
                    out_split_sizes=out_split_sizes, group=group,
                    sync_op=sync_op),
                in_tensor, group, sync_op, use_calc_stream)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True,
           use_calc_stream=False):
    return _run("gather",
                lambda: _cx.gather(tensor, gather_list=gather_list,
                                   dst=dst, group=group, sync_op=sync_op),
                tensor, group, sync_op, use_calc_stream)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    """p2p stream send; the async (``sync_op=False``) form is in the ring
    as well."""
    return _run("send",
                lambda: _cx.send(tensor, dst=dst, group=group,
                                 sync_op=sync_op),
                tensor, group, sync_op, use_calc_stream, p2p=True)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _run("recv",
                lambda: _cx.recv(tensor, src=src, group=group,
                                 sync_op=sync_op),
                tensor, group, sync_op, use_calc_stream, p2p=True)
