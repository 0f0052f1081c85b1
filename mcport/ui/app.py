# -*- coding: utf-8 -*-
"""Streamlit UI — parity layer over the mcport engine.

Reproduces the reference app's surface (app.py:13-809): Persian labels, dark CSS
theme, sidebar (upload / online download / global settings / weight bounds), and
the four tabs (asset stats, strategies & payoff, portfolio simulation, price
forecast) — but every computation routes through the mcport JAX layers
instead of inline NumPy loops.

Run: ``streamlit run mcport/ui/app.py`` (streamlit+plotly are optional deps —
this module import-fails with a clear message without them; the library/CLI tiers
never import it).

Intentional divergences from the reference (all documented in SURVEY.md §2):
- risk-free rate is interpreted as percent and converted to decimal before use
  (the reference uses 3.0 as a 300% decimal rate);
- CSV prices with thousands separators load correctly;
- an Equal-Weight portfolio violating the bounds shows a warning instead of
  crashing with IndexError;
- a sixth method, Target Risk (sigma <= 30%), from the upstream README.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

try:
    import plotly.express as px
    import plotly.graph_objects as go
    import streamlit as st
except ImportError as _e:  # pragma: no cover - UI tier is optional
    raise ImportError(
        "mcport.ui requires streamlit and plotly (UI-tier optional dependencies): "
        f"{_e}"
    ) from _e

from mcport.config import Config, DataConfig, PortfolioConfig, SimulationConfig
from mcport.data import PriceSeries, dedupe_names, read_csv_file
from mcport.data.pipeline import combine_prices, stats_returns
from mcport.data.yf_loader import download_prices
from mcport.engine import run_simulation
from mcport.models import forecast_prices
from mcport.options import Legs, strategy_legs
from mcport.stats import DISPLAY_COLUMNS, asset_stats_batch
from mcport.ui.view import forecast_view, frontier_view, payoff_view

st.set_page_config(page_title="شبیه‌ساز پرتفوی حرفه‌ای", layout="wide")

# dark theme CSS, as in app.py:16-68
st.markdown(
    """
    <style>
    .main { background-color: #1e1e1e; color: #e0e0e0; }
    .stButton>button { background-color: #4CAF50; color: white; border-radius: 5px;
                       padding: 5px 15px; transition: all 0.3s; }
    .stButton>button:hover { background-color: #45a049; }
    .stNumberInput>input { background-color: #2e2e2e; color: #e0e0e0;
                           border: 1px solid #444; border-radius: 5px; }
    .stExpander { background-color: #2e2e2e; border: 1px solid #444; border-radius: 5px; }
    .stExpander > div[data-testid="stExpanderHeader"] { color: #e0e0e0; }
    .stTabs [data-baseweb="tab-list"] { background-color: #2e2e2e;
                                        border-bottom: 1px solid #444; }
    .stTabs [data-baseweb="tab"] { background-color: #2e2e2e; color: #bbb;
                                   padding: 10px 20px; border: none; }
    .stTabs [data-baseweb="tab--selected"] { background-color: #4CAF50; color: white;
                                             border-radius: 5px 5px 0 0; }
    </style>
    """,
    unsafe_allow_html=True,
)

# ---------- session state (app.py:366-376) ----------
for key, default in [
    ("downloaded_dfs", []),
    ("uploaded_dfs", []),
    ("option_rows", {}),
    ("investment_amount", 10000.0),
]:
    if key not in st.session_state:
        st.session_state[key] = default

# ---------- sidebar: data management (app.py:379-422) ----------
st.sidebar.header("📂 مدیریت داده‌ها")
with st.sidebar.expander("بارگذاری فایل‌ها 📤"):
    uploaded_files = st.file_uploader(
        "آپلود فایل‌های CSV (هر دارایی یک فایل)",
        type=["csv"], accept_multiple_files=True, key="uploader",
    )
    if uploaded_files:
        # Reference semantics (app.py:385-390): each uploaded FILE is
        # ingested once — a same-name re-upload is a new file and appends a
        # new asset, disambiguated later by dedupe_names' Counter suffix
        # (app.py:441-447). The reference marks the UploadedFile OBJECT,
        # which only stays idempotent if streamlit returns the same object
        # every rerun; we key on the stable per-upload file_id when the
        # streamlit version exposes it, so a widget-triggered rerun can
        # never re-append, and fall back to the reference's object mark.
        seen_ids = st.session_state.setdefault("_ingested_upload_ids", set())
        for file in uploaded_files:
            fid = getattr(file, "file_id", None)
            if fid is not None:
                if fid in seen_ids:
                    continue
            elif getattr(file, "uploaded_in_session", False):
                continue
            try:
                df = read_csv_file(file)
                st.session_state["uploaded_dfs"].append(
                    (file.name.split(".")[0], df))
            except Exception as e:
                st.error(f"خطا در خواندن فایل {file.name}: {e}")
            if fid is not None:
                seen_ids.add(fid)
            else:
                file.uploaded_in_session = True

with st.sidebar.expander("دریافت داده آنلاین 📥"):
    st.markdown(
        '<div dir="rtl" style="text-align: right;"><b>راهنما:</b><br>'
        'نمادها را با کاما و بدون فاصله وارد کنید (مثال: '
        '<span style="direction:ltr;display:inline-block">BTC-USD,AAPL,ETH-USD</span>)</div>',
        unsafe_allow_html=True,
    )
    tickers_input = st.text_input("نماد دارایی‌ها")
    start = st.date_input("تاریخ شروع", value=pd.to_datetime("2023-01-01"))
    end = st.date_input("تاریخ پایان", value=pd.to_datetime("today"))
    if st.button("دریافت داده") and tickers_input.strip():
        results = download_prices(tickers_input.split(","), start, end)
        for t, df, err in results:
            if df is not None:
                st.session_state["downloaded_dfs"].append((t, PriceSeries(
                    df["Date"].to_numpy("datetime64[s]"),
                    df["Price"].to_numpy(np.float64))))
                st.success(f"داده {t} با موفقیت دانلود شد.")
            else:
                st.error(err)

with st.sidebar.expander("تنظیمات کلی ⚙️"):
    period = st.selectbox("بازه تحلیل بازده", ["ماهانه", "سه‌ماهه", "هفتگی"])
    period_code = {"ماهانه": "M", "سه‌ماهه": "Q", "هفتگی": "W"}[period]
    data_cfg = DataConfig(period=period_code)
    # divergence: percent → decimal (the reference feeds 3.0 straight into
    # decimal-scale formulas, i.e. 300%/yr — SURVEY.md §2 risk-free units bug)
    user_rf_pct = st.number_input("نرخ بدون ریسک سالانه (%)", value=3.0, key="user_rf")
    user_rf = user_rf_pct / 100.0
    with st.form(key="settings_form"):
        investment_amount = st.number_input(
            "💵 سرمایه کل (دلار)",
            value=float(st.session_state["investment_amount"]),
            key="investment_amount_input",
        )
        if st.form_submit_button(label="ثبت"):
            st.session_state["investment_amount"] = investment_amount

# ---------- weight constraints (app.py:437-458) ----------
all_dfs = st.session_state["downloaded_dfs"] + st.session_state["uploaded_dfs"]
asset_names: list[str] = dedupe_names([t for t, _ in all_dfs])
min_weights, max_weights = [], []
if all_dfs:
    with st.sidebar.expander("محدودیت وزن دارایی‌ها 🔒"):
        cols = st.columns(2)
        for i, name in enumerate(asset_names):
            with cols[i % 2]:
                min_weights.append(st.number_input(f"حداقل وزن {name}", value=0.0, key=f"minw_{name}"))
                max_weights.append(st.number_input(f"حداکثر وزن {name}", value=1.0, key=f"maxw_{name}"))

tabs = st.tabs(["📊 آمار دارایی‌ها", "⚙️ معاملات و استراتژی‌ها", "📈 شبیه‌سازی پرتفوی", "🔮 پیش‌بینی قیمت"])

if not all_dfs:
    with tabs[0]:
        st.warning("⚠️ لطفاً داده‌ای بارگذاری یا دریافت کنید.")
else:
    dates, prices = combine_prices(all_dfs, data_cfg.resample_rule)
    resampled = pd.DataFrame(prices, index=pd.DatetimeIndex(dates),
                             columns=asset_names)
    ann = data_cfg.annual_factor

    # lightweight PriceData stand-in built from the live widgets
    from mcport.data.pipeline import PriceData, annualized_moments, portfolio_returns

    prets = portfolio_returns(prices)
    mean_ann, cov_ann = annualized_moments(prets, ann)
    data = PriceData(
        names=tuple(asset_names),
        prices=prices,
        stats_rets=stats_returns(prices),
        port_rets=prets,
        mean_ann=mean_ann,
        cov_ann=cov_ann,
        ann_factor=ann,
        resample_rule=data_cfg.resample_rule,
        dates=dates,
    )

    # ---- tab 0: asset statistics (app.py:463-497) ----
    with tabs[0]:
        st.markdown("### 📊 آمار کلیدی دارایی‌ها")
        stats = asset_stats_batch(data.stats_rets.T, ann, user_rf)
        stats_df = pd.DataFrame(
            {k: np.asarray(stats[k]) for k in DISPLAY_COLUMNS}, index=asset_names
        )
        st.write(stats_df)

    # ---- tab 1: strategies & payoff (app.py:499-653) ----
    with tabs[1]:
        st.markdown("### ⚙️ معاملات و استراتژی‌ها")
        legs_by_asset: dict[str, Legs] = {}
        purchase, qty_assets = {}, {}
        for name in asset_names:
            with st.expander(f"📋 تنظیمات {name}"):
                strategy = st.selectbox(
                    "استراتژی انتخابی",
                    ["-", "Married Put", "Protective Put", "Covered Call", "Collar",
                     "Bear Put Spread", "Synthetic Put", "Long Straddle/Strangle"],
                    key=f"strategy_{name}",
                )
                spot = float(resampled[name].iloc[-1])
                purchase[name] = st.number_input(
                    f"قیمت خرید دارایی پایه ({name})", value=spot, key=f"purchase_price_{name}")
                qty_assets[name] = st.number_input(
                    f"مقدار دارایی پایه ({name})", value=1.0, key=f"qty_asset_{name}")
                kwargs = {}
                if strategy in ("Married Put", "Protective Put"):
                    kwargs = dict(
                        strike_put=st.number_input("قیمت اعمال پوت", value=spot * 0.9, key=f"mp_sp_{name}"),
                        premium_put=st.number_input("پریمیوم پوت", value=0.0, key=f"mp_pp_{name}"),
                        qty_contract=st.number_input("مقدار قرارداد پوت", value=1.0, key=f"mp_qc_{name}"),
                    )
                elif strategy == "Covered Call":
                    kwargs = dict(
                        strike_call=st.number_input("قیمت اعمال کال", value=spot * 1.1, key=f"cc_sc_{name}"),
                        premium_call=st.number_input("پریمیوم کال", value=0.0, key=f"cc_pc_{name}"),
                        qty_contract=st.number_input("مقدار قرارداد کال", value=1.0, key=f"cc_qc_{name}"),
                    )
                elif strategy == "Collar":
                    kwargs = dict(
                        strike_put=st.number_input("قیمت اعمال پوت", value=spot * 0.9, key=f"col_sp_{name}"),
                        premium_put=st.number_input("پریمیوم پوت", value=0.0, key=f"col_pp_{name}"),
                        strike_call=st.number_input("قیمت اعمال کال", value=spot * 1.1, key=f"col_sc_{name}"),
                        premium_call=st.number_input("پریمیوم کال", value=0.0, key=f"col_pc_{name}"),
                        qty_contract=st.number_input("مقدار قرارداد پوت/کال", value=1.0, key=f"col_qc_{name}"),
                    )
                elif strategy == "Bear Put Spread":
                    kwargs = dict(
                        strike_put_high=st.number_input("قیمت اعمال پوت بالا", value=spot, key=f"bps_sph_{name}"),
                        premium_put_high=st.number_input("پریمیوم پوت بالا", value=0.0, key=f"bps_pph_{name}"),
                        strike_put_low=st.number_input("قیمت اعمال پوت پایین", value=spot * 0.9, key=f"bps_spl_{name}"),
                        premium_put_low=st.number_input("پریمیوم پوت پایین", value=0.0, key=f"bps_ppl_{name}"),
                        qty_contract=st.number_input("مقدار قرارداد پوت", value=1.0, key=f"bps_qc_{name}"),
                    )
                elif strategy == "Synthetic Put":
                    kwargs = dict(
                        strike_call=st.number_input("قیمت اعمال کال", value=spot, key=f"syn_sc_{name}"),
                        premium_call=st.number_input("پریمیوم کال", value=0.0, key=f"syn_pc_{name}"),
                        qty_contract=st.number_input("مقدار قرارداد کال", value=1.0, key=f"syn_qc_{name}"),
                    )
                elif strategy == "Long Straddle/Strangle":
                    kwargs = dict(
                        strike_call=st.number_input("قیمت اعمال کال", value=spot, key=f"ls_sc_{name}"),
                        premium_call=st.number_input("پریمیوم کال", value=0.0, key=f"ls_pc_{name}"),
                        strike_put=st.number_input("قیمت اعمال پوت", value=spot, key=f"ls_sp_{name}"),
                        premium_put=st.number_input("پریمیوم پوت", value=0.0, key=f"ls_pp_{name}"),
                        qty_contract=st.number_input("مقدار قرارداد کال/پوت", value=1.0, key=f"ls_qc_{name}"),
                    )
                legs = strategy_legs(strategy, spot, qty_asset=qty_assets[name], **kwargs)
                if len(legs):
                    legs_by_asset[name] = legs
        st.session_state["option_rows"] = {
            n: legs.rows() for n, legs in legs_by_asset.items()
        }

        st.markdown("### 📊 نمودار سود و زیان")
        _VLINE_LABELS = {"breakeven": "نقطه سربه‌سر", "spot": "قیمت فعلی"}
        for name, legs in legs_by_asset.items():
            spot = float(resampled[name].iloc[-1])
            v = payoff_view(legs, purchase[name], qty_assets[name], spot)

            fig = go.Figure()
            fig.add_trace(go.Scatter(
                x=v.grid, y=v.payoffs, mode="lines", fill="tozeroy",
                line=dict(color=v.base_color),
                name=f"سود و زیان {name}",
                hovertemplate="قیمت: %{x:.2f}<br>سود/زیان: %{y:.2f}<br>درصد: %{text:.2f}%<extra></extra>",
                text=v.pl_pct,
            ))
            for x0, x1, y0, y1, color in v.segments:   # zero-crossing flips
                fig.add_trace(go.Scatter(
                    x=[x0, x1], y=[y0, y1], mode="lines", fill="tonexty",
                    line=dict(color=color), showlegend=False, hoverinfo="skip",
                ))
            for x, color, key in v.vlines:
                fig.add_trace(go.Scatter(
                    x=[x, x], y=[v.max_loss, v.max_profit], mode="lines",
                    line=dict(color=color, dash="dash"),
                    name=_VLINE_LABELS[key],
                ))
            fig.update_layout(title=f"نمودار سود و زیان برای {name}",
                              xaxis_title="قیمت دارایی", yaxis_title="سود و زیان (دلار)",
                              template="plotly_white", showlegend=True)
            st.plotly_chart(fig, use_container_width=True)

            st.markdown(f"### 📋 تحلیل استراتژی برای {name}")
            st.markdown(f"**نقطه سربه‌سر**: {v.analysis['breakeven']} دلار")
            st.markdown(f"**حداکثر سود**: {v.analysis['max_profit']}")
            st.markdown(f"**حداکثر زیان**: {v.analysis['max_loss']}")
        if st.button("🔄 به‌روزرسانی"):
            st.rerun()

    # ---- tab 2: portfolio simulation (app.py:655-783) ----
    with tabs[2]:
        st.markdown("### 📈 شبیه‌سازی پرتفوی")
        cfg = Config(
            portfolio=PortfolioConfig(
                risk_free=user_rf,
                investment_amount=st.session_state["investment_amount"],
                min_weights=tuple(min_weights) if min_weights else None,
                max_weights=tuple(max_weights) if max_weights else None,
            ),
            simulation=SimulationConfig(n_portfolios=2500),
        )
        out = run_simulation(data, cfg, legs_by_asset=legs_by_asset)
        for method, r in out.results.items():
            st.markdown(f"#### مرز کارا - {method}")
            v = frontier_view(method, r, asset_names, user_rf,
                              st.session_state["investment_amount"])
            if v is None:
                st.warning("هیچ پرتفویی با محدودیت‌های وزن سازگار نیست.")
                continue
            fig = go.Figure()
            fig.add_trace(go.Scatter(
                x=v.xs, y=v.ys, mode="markers",
                marker=dict(color=v.colors, colorscale=v.colorscale,
                            colorbar=dict(title=v.metric_name.upper()), size=7),
                name="پرتفوی‌ها",
            ))
            if v.cal is not None:
                fig.add_trace(go.Scatter(x=v.cal[0], y=v.cal[1], mode="lines",
                                         line=dict(dash="dash", color="red"),
                                         name="خط بازار سرمایه (CAL)"))
            fig.add_trace(go.Scatter(
                x=[v.opt_x], y=[v.opt_y],
                mode="markers+text", marker=dict(size=14, color="red"),
                text=[f"بهینه {method}"], textposition="top right",
                name=f"پرتفوی بهینه {method}",
            ))
            fig.update_layout(title=f"مرز کارا - {method}",
                              xaxis_title="ریسک (%)", yaxis_title="بازده (%)")
            st.plotly_chart(fig, use_container_width=True)

            st.markdown(f"#### تخصیص دارایی - {method}")
            cols = st.columns(len(asset_names))
            for i, (name, pct, money) in enumerate(v.cards):
                with cols[i]:
                    st.markdown(
                        f"<div style='text-align:center;direction:rtl'><b>{name}</b><br>"
                        f"{pct}<br>{money}</div>",
                        unsafe_allow_html=True,
                    )
            st.plotly_chart(
                px.pie(values=v.pie_values, names=list(v.pie_names),
                       title=f"توزیع دلاری پرتفوی بهینه - {method}", hole=0.4),
                use_container_width=True,
            )

    # ---- tab 3: forecasting (app.py:785-809) ----
    with tabs[3]:
        st.markdown("### 🔮 پیش‌بینی قیمت دارایی‌ها")
        for i, name in enumerate(asset_names):
            st.markdown(f"#### پیش‌بینی برای {name}")
            forecasts = forecast_prices(data.prices[:, i])
            v = forecast_view(float(data.prices[-1, i]), forecasts)
            fig = go.Figure()
            fig.add_trace(go.Scatter(x=[0], y=[v.last_price], mode="markers",
                                     name="قیمت فعلی", marker=dict(size=10, color="blue")))
            for (h, price, label), (_, lo, hi) in zip(v.points, v.ci_segments):
                fig.add_trace(go.Scatter(
                    x=[h], y=[price], mode="markers+text",
                    text=[label], textposition="top center",
                    name=f"{h} ماه", marker=dict(size=8),
                ))
                fig.add_trace(go.Scatter(
                    x=[h, h], y=[lo, hi], mode="lines",
                    line=dict(color="gray", dash="dash"),
                    name=f"بازه اطمینان {h} ماه",
                ))
            fig.update_layout(title=f"پیش‌بینی قیمت {name}",
                              xaxis_title="افق زمانی (ماه)",
                              yaxis_title="قیمت پیش‌بینی‌شده ($)",
                              template="plotly_white")
            st.plotly_chart(fig, use_container_width=True)
