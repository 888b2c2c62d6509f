"""Peer client engine (reference counterpart: client/).

The dfdaemon equivalent: piece-granular local storage with reuse
(``storage``), the HTTP piece upload server (``upload``), back-to-source
protocol clients (``source``), the piece downloader/dispatcher and the
peer-task engine (``peer``), plus host announcing and probe sending.
"""
