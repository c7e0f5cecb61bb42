"""The gsnative C++ codec (`gsnative.cpp`) and its build (`build.py`)."""
