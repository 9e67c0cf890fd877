"""PyTorch port: the threaded logger prints every queued line, in order and
on its stream, without pacing the lines."""

import time

from metdetpy_tpu_torch.log import LV_PROCESSING, ThreadMetLog


def test_thread_logger_flushes_every_line_in_order_without_pacing(capsys):
    """300 lines queued at once are all printed, in order, when stop()
    returns, and the FATAL line goes to stderr. A pause of 20 ms a line
    (the reference's pacing) would take 6 s; the flush takes well under
    2 s."""
    printed = []
    log = ThreadMetLog(pipe=lambda line, flush: printed.append(line),
                       log_level=LV_PROCESSING)
    log.start()
    t0 = time.perf_counter()
    for i in range(300):
        log.processing(str(i))
    log.fatal("the end")
    log.debug("below the level: dropped")
    log.stop()
    elapsed = time.perf_counter() - t0
    assert printed == [f"Processing: {i}" for i in range(300)]
    assert capsys.readouterr().err == "Fatal: the end\n"
    assert log.is_empty and elapsed < 2.0
