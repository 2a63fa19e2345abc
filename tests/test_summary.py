"""SummaryWriter round-trip."""

from of_spmm.utils.summary import SummaryWriter, read_events


def test_summary_roundtrip(tmp_path):
    d = str(tmp_path)
    with SummaryWriter(d) as w:
        w.add_scalar("loss", 1.5, step=0)
        w.add_scalars("eval", {"acc": 0.5, "f1": 0.4}, step=1)
        w.add_text("note", "hello", step=1)
    ev = read_events(d)
    assert len(ev) == 4
    assert ev[0]["tag"] == "loss" and ev[0]["value"] == 1.5
    tags = {e["tag"] for e in ev}
    assert {"eval/acc", "eval/f1", "note"} <= tags
    # append-safe across reopen
    with SummaryWriter(d) as w:
        w.add_scalar("loss", 1.0, step=2)
    assert len(read_events(d)) == 5
