"""Butterworth band filters (reference ``seismic/filter/filter.py``); the
port's copy of ``devito_fwi_tpu.utils.filters`` (numpy and scipy).

The reference vendors ObsPy's scipy-based filters plus a SciPy-0.16
``_sosfilt`` backport; modern scipy has everything, so this is a direct
thin implementation with the same signatures and semantics (corner
clamping at Nyquist, zerophase = forward-backward application).
"""
from __future__ import annotations

import warnings

import numpy as np
from scipy.signal import iirfilter, sosfilt, zpk2sos, hilbert

__all__ = ["bandpass", "bandstop", "lowpass", "highpass", "envelope",
           "remez_fir", "lowpass_fir", "integer_decimation",
           "lowpass_cheby_2"]


def bandpass(data, freqmin, freqmax, df, corners=4, zerophase=False, axis=-1):
    fe = 0.5 * df
    low = freqmin / fe
    high = freqmax / fe
    if high - 1.0 > -1e-6:
        warnings.warn("bandpass: upper corner %s Hz >= Nyquist %s Hz — "
                      "falling back to a high-pass at the lower corner."
                      % (freqmax, fe))
        return highpass(data, freq=freqmin, df=df, corners=corners,
                        zerophase=zerophase, axis=axis)
    if low > 1:
        raise ValueError("bandpass: lower corner exceeds Nyquist.")
    z, p, k = iirfilter(corners, [low, high], btype="band", ftype="butter",
                        output="zpk")
    sos = zpk2sos(z, p, k)
    if zerophase:
        firstpass = sosfilt(sos, data, axis=axis)
        return np.flip(sosfilt(sos, np.flip(firstpass, axis=axis), axis=axis),
                       axis=axis)
    return sosfilt(sos, data, axis=axis)


def bandstop(data, freqmin, freqmax, df, corners=4, zerophase=False, axis=-1):
    fe = 0.5 * df
    low = freqmin / fe
    high = freqmax / fe
    if high > 1:
        high = 1.0
        warnings.warn("bandstop: upper corner exceeds Nyquist — clamping "
                      "it to Nyquist.")
    if low > 1:
        raise ValueError("bandstop: lower corner exceeds Nyquist.")
    z, p, k = iirfilter(corners, [low, high], btype="bandstop",
                        ftype="butter", output="zpk")
    sos = zpk2sos(z, p, k)
    if zerophase:
        firstpass = sosfilt(sos, data, axis=axis)
        return np.flip(sosfilt(sos, np.flip(firstpass, axis=axis), axis=axis),
                       axis=axis)
    return sosfilt(sos, data, axis=axis)


def lowpass(data, freq, df, corners=4, zerophase=False, axis=-1):
    fe = 0.5 * df
    f = freq / fe
    if f > 1:
        f = 1.0
        warnings.warn("lowpass: corner exceeds Nyquist — clamping it to "
                      "Nyquist.")
    z, p, k = iirfilter(corners, f, btype="lowpass", ftype="butter",
                        output="zpk")
    sos = zpk2sos(z, p, k)
    if zerophase:
        firstpass = sosfilt(sos, data, axis=axis)
        return np.flip(sosfilt(sos, np.flip(firstpass, axis=axis), axis=axis),
                       axis=axis)
    return sosfilt(sos, data, axis=axis)


def highpass(data, freq, df, corners=4, zerophase=False, axis=-1):
    fe = 0.5 * df
    f = freq / fe
    if f > 1:
        raise ValueError("highpass: corner exceeds Nyquist.")
    z, p, k = iirfilter(corners, f, btype="highpass", ftype="butter",
                        output="zpk")
    sos = zpk2sos(z, p, k)
    if zerophase:
        firstpass = sosfilt(sos, data, axis=axis)
        return np.flip(sosfilt(sos, np.flip(firstpass, axis=axis), axis=axis),
                       axis=axis)
    return sosfilt(sos, data, axis=axis)


def envelope(data):
    return abs(hilbert(data))

def remez_fir(data, freqmin, freqmax, df):
    """Minimax-optimal FIR bandpass via the Remez exchange algorithm
    (reference ``seismic/filter/filter.py:199-266``): 50 taps, 10%
    transition bands around the corners, full convolution output."""
    from scipy.signal import remez, convolve
    flt = freqmin - 0.1 * freqmin
    fut = freqmax + 0.1 * freqmax
    filt = remez(50, np.array([0, flt, freqmin, freqmax, fut, df / 2 - 1]),
                 np.array([0, 1, 0]), fs=df)
    return convolve(filt, data)


def lowpass_fir(data, freq, df, winlen=2048):
    """FIR lowpass: ideal brick-wall response windowed with a Kaiser
    (beta=11.7) window (reference ``filter.py:268-304``, with its py2
    float-slice bug fixed)."""
    from scipy.signal import convolve, get_window
    w = np.fft.fftfreq(winlen, 1 / float(df))
    myfilter = np.where((abs(w) < freq), 1., 0.)
    h = np.fft.ifft(myfilter)
    beta = 11.7
    myh = np.fft.fftshift(h) * get_window(beta, winlen)
    return convolve(abs(myh), data)[winlen // 2:-winlen // 2]


def integer_decimation(data, decimation_factor):
    """Downsample by keeping every decimation_factor-th sample
    (reference ``filter.py:306-324``)."""
    if not isinstance(decimation_factor, int):
        raise TypeError("Decimation_factor must be an integer!")
    return np.array(data[::decimation_factor])


def lowpass_cheby_2(data, freq, df, maxorder=12, ba=False,
                    freq_passband=False, axis=-1):
    """Chebyshev-II lowpass for anti-alias downsampling: iteratively lowers
    the passband edge until the order fits maxorder with 96 dB stopband
    attenuation (reference ``filter.py:327-370``)."""
    from scipy.signal import cheb2ord, cheby2
    nyquist = df * 0.5
    rp, rs, order = 1, 96, 1e99
    ws = freq / nyquist
    wp = ws
    if ws > 1:
        ws = 1.0
        warnings.warn("lowpass_cheby_2: corner exceeds Nyquist — clamping "
                      "it to Nyquist.")
    wn = ws
    while True:
        if order <= maxorder:
            break
        wp = wp * 0.99
        order, wn = cheb2ord(wp, ws, rp, rs, analog=0)
    if ba:
        return cheby2(order, rs, wn, btype="low", analog=0, output="ba")
    z, p, k = cheby2(order, rs, wn, btype="low", analog=0, output="zpk")
    sos = zpk2sos(z, p, k)
    if freq_passband:
        return sosfilt(sos, data, axis=axis), wp * nyquist
    return sosfilt(sos, data, axis=axis)
